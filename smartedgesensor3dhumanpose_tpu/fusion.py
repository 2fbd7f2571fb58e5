"""Multi-view fusion: cross-view association + triangulation of one frame.

Accelerator rebuild of the reference's skeleton_3d node hot path
(skeleton_3d_triang_mult_node.cpp triangulate_persons, :525-997):

* iterative greedy association over the camera axis (Tanke & Gall 2019,
  :562-674) — a fold over cameras carrying a fixed-slot hypothesis set
  (`lax.scan`, or one Triton kernel program per frame on a GPU),
* per-joint confidence-weighted DLT triangulation with 3-view / leave-one-out
  outlier rejection (:676-844) — all leave-one-out variants computed as one
  extra batch axis and selected with `argmin`/`where`,
* unscented 3D covariance (:508-523, via ops.covariance),
* anatomical plausibility filters and skeleton merging (:861-996).

The reference parallelizes hypotheses with OpenMP threads and erases views
from std::vectors; here every hypothesis/joint/drop-candidate/sigma-point is
a batch lane and every "erase" is a mask update, so the whole frame is one
fixed-shape XLA program.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smartedgesensor3dhumanpose_tpu import cameras as cameras_lib
from smartedgesensor3dhumanpose_tpu import skeleton
from smartedgesensor3dhumanpose_tpu.config import FusionConfig
from smartedgesensor3dhumanpose_tpu.ops import (
    covariance,
    epipolar,
    hungarian,
    linalg,
    triangulation,
)
from smartedgesensor3dhumanpose_tpu.types import CameraRig, Frame, Persons3D

# Costs fed to the assignment solver are clipped here: all placeholder
# (infeasible) entries collapse to one value that still dominates any real
# epipolar cost, keeping float32 reduced costs accurate (see ops.hungarian).
_ASSIGN_COST_CLIP = 1.0e3
# Deterministic tie-break for clipped (infeasible) entries: each adds
# eps * (hyp_index + 1) * (det_index + 1). Equal-total optima that differ in
# which infeasible detection a hypothesis absorbs would otherwise be broken
# by solver internals; the product term is symmetric under transposition,
# so a solver of either orientation picks the same assignment. Small
# enough (< 17 at 128x128 slots) never to flip a feasible-vs-infeasible or
# cross-tier comparison, large enough that distinct products differ by well
# over the float32 resolution at 1e3 (~1.2e-4).
_SOLVER_TIE_EPS = 1.0e-3
# Invalid detection slots get a strictly higher tier than valid-but-
# infeasible pairings, so a hypothesis with no feasible detection is
# assigned a VALID infeasible detection whenever one is available. Which
# invalid slot absorbs a hypothesis is consumer-invariant (both spawn
# nothing), so this tier needs no tie-break.
_INVALID_DET_COST = 2.0 * _ASSIGN_COST_CLIP


class HypothesisSet(NamedTuple):
    """Fixed-slot person hypotheses accumulated across cameras.

    Mirrors the reference's PersonHypothesis vectors (:153-159) with the
    camera axis materialized: slot h observes camera c iff cam_mask[h, c].
    """

    kp: jnp.ndarray        # [H, C, J, 3] normalized keypoints (x, y, conf)
    cov: jnp.ndarray       # [H, C, J, 3] packed normalized covariance
    cam_mask: jnp.ndarray  # [H, C] bool
    obs_score: jnp.ndarray  # [H, C] per-observation person score
    n_hyp: jnp.ndarray     # [] int32 live hypothesis count
    # Spawns silently lost to the fixed slot capacity (the reference grows
    # its hypothesis vector unboundedly, :662-673; here overflow is counted
    # so the monitor can warn instead of losing people invisibly).
    n_dropped: jnp.ndarray  # [] int32


class _AssocCarry(NamedTuple):
    """Association scan state: which detection each hypothesis observes in
    each camera (the hypothesis' keypoints are gathered once after the scan).

    Mirrors the reference's PersonHypothesis cameraIDs vectors (:153-159);
    the observation *data* never moves during association.
    """

    det_slot: jnp.ndarray  # [H, C] int32, -1 where camera not in hypothesis
    cam_mask: jnp.ndarray  # [H, C] bool
    n_hyp: jnp.ndarray     # [] int32 live hypothesis count
    n_dropped: jnp.ndarray  # [] int32 spawns dropped (capacity overflow)


def _associate_camera(
    carry: _AssocCarry,
    cam_idx: jnp.ndarray,
    ctab_c: jnp.ndarray,
    conf_obs: jnp.ndarray,
    det_ok: jnp.ndarray,
    config: FusionConfig,
) -> _AssocCarry:
    """One greedy-association step: fold camera `cam_idx`'s detections into
    the hypothesis set (reference :588-674).

    The hypothesis x detection cost matrix is assembled from the
    frame-level precomputed per-observation pair costs
    (ops.epipolar.pairwise_association_costs, packaged by `associate`) with
    ONE one-hot matmul over the hypotheses' observation identities — the
    sequential step does no epipolar math and materializes no [H, C, D]
    intermediates. Every indexed access is a one-hot contraction or masked
    reduction (no vector-indexed gather or scatter inside the sequential
    fold); the 0/1-weighted matmuls under Precision.HIGHEST are exact.

    When no hypothesis exists yet every valid detection seeds one — which
    reproduces the reference's 'first camera with usable detections seeds
    the set' rule (:566-586) without a special case.

    Args:
      ctab_c: [C*D', D] per-observation cost against the current camera's
        detections, flattened over (camera, detection); -1 sentinel where
        the pair is unusable (no shared confident joint / same camera /
        future camera). Costs are >= 0, so usability is `ctab_c >= 0`.
      conf_obs: [C*D'] observation confident-voter flag ((score > 0.5),
        :352) per source observation.
      det_ok: [D] bool — usable detections of the current camera.
    """
    h, c = carry.det_slot.shape
    d = det_ok.shape[0]
    dtype = ctab_c.dtype
    d1 = ctab_c.shape[0] // c

    # One-hot observation identities [H, C*D']: row (h, c'*D'+d') is 1 iff
    # hypothesis h observes detection d' in camera c'. Cameras not in the
    # hypothesis have det_slot -1 -> all-zero block, so cam_mask is encoded.
    onehot = (
        carry.det_slot[:, :, None] == jnp.arange(d1, dtype=jnp.int32)
    ).astype(dtype).reshape(h, c * d1)
    # Derive the four per-observation tables from the sentinel cost block
    # ([0] cost*usable, [1] usable, [2] usable & cost>gate & confident,
    # [3] usable & cost>gate; the gate is > 0 > sentinel so `big` needs no
    # usable mask) and contract them in one [H, X] x [X, 4D] matmul.
    usable = (ctab_c >= 0).astype(dtype)
    big = (ctab_c > config.max_epipolar_error).astype(dtype)
    rhs = jnp.concatenate(
        [
            jnp.maximum(ctab_c, 0.0),
            usable,
            big * conf_obs[:, None],
            big,
        ],
        axis=1,
    )  # [X, 4D]
    sums = linalg.heinsum("hx,xe->he", onehot, rhs).reshape(h, 4, d)
    total, n_obs_used, votes_conf, votes_all = (
        sums[:, 0], sums[:, 1], sums[:, 2], sums[:, 3]
    )

    # Mean per-observation cost over observations sharing joints (:344-366).
    obs_in_hyp = carry.cam_mask
    n_obs_in_hyp = jnp.sum(obs_in_hyp, axis=-1)  # [H]
    cost = total / jnp.maximum(n_obs_used, 1.0)

    # Veto accumulation (:344-381): only confident observations vote —
    # except in a single-observation hypothesis, where the lone observation
    # always votes; each vote adds 1/n_obs_in_hyp.
    n_votes = jnp.where(
        (n_obs_in_hyp == 1)[:, None], votes_all, votes_conf
    )
    n_obs_f = jnp.maximum(n_obs_in_hyp, 1).astype(dtype)
    tmp_veto = n_votes / n_obs_f[:, None]
    tolerance = 1.0 - 1.0 / (2.0 * n_obs_f)
    veto = tmp_veto > tolerance[:, None]

    unusable = (n_obs_used < 0.5) | (n_obs_in_hyp[:, None] == 0)
    cost = jnp.where(unusable, config.max_cost, cost)
    veto = veto | unusable
    cost = jnp.where(det_ok[None, :], cost, config.max_cost)
    veto = veto | ~det_ok[None, :]

    mask = ~veto & (cost < config.max_epipolar_error)  # feasible pairings

    # Run the assignment solver only when some row or column has more than
    # one feasible pairing (:628); otherwise the mask itself is the unique
    # assignment.
    need_solver = jnp.any(jnp.sum(mask, axis=0) > 1) | jnp.any(
        jnp.sum(mask, axis=1) > 1
    )

    def from_mask(_):
        any_row = jnp.any(mask, axis=1)
        return jnp.where(
            any_row, jnp.argmax(mask, axis=1).astype(jnp.int32), -1
        )

    # Clip + deterministic tie-break (see _SOLVER_TIE_EPS/_INVALID_DET_COST
    # above): infeasible entries become CLIP + eps*(h+1)*(d+1), invalid
    # detection slots a strictly higher constant tier.
    h_idx = jnp.arange(h, dtype=dtype)[:, None]
    d_idx = jnp.arange(d, dtype=dtype)[None, :]
    clipped = jnp.minimum(cost, _ASSIGN_COST_CLIP)
    tie_cost = jnp.where(
        clipped >= _ASSIGN_COST_CLIP,
        _ASSIGN_COST_CLIP + _SOLVER_TIE_EPS * (h_idx + 1.0) * (d_idx + 1.0),
        clipped,
    )
    tie_cost = jnp.where(det_ok[None, :], tie_cost, _INVALID_DET_COST)

    def from_solver(_):
        # unroll=False keeps a while_loop in this branch so XLA cannot
        # speculate it; the solver only actually executes on the (rare)
        # frames with ambiguous pairings (:628).
        return hungarian.linear_sum_assignment(tie_cost, unroll=False)

    assignment = jax.lax.cond(need_solver, from_solver, from_mask, None)

    # Interpret the assignment (:636-673). An assigned *valid* detection
    # either extends the hypothesis (feasible) or spawns a new one
    # (assigned by the solver but infeasible); unassigned valid detections
    # spawn new hypotheses too. All index plumbing is one-hot algebra
    # (every `A`/`S` row has at most one nonzero, so the sums are exact
    # selections, not approximations).
    dets = jnp.arange(d, dtype=jnp.int32)
    A = assignment[:, None] == dets[None, :]  # [H, D] one-hot assignment
    assigned_valid = jnp.any(A & det_ok[None, :], axis=1)  # [H]
    pair_ok = jnp.any(A & mask, axis=1)  # [H] assigned pairing feasible
    extend = assigned_valid & pair_ok  # [H]
    spawn_from_hyp = assigned_valid & ~pair_ok  # [H] spawns its detection
    det_of_hyp = jnp.sum(jnp.where(A, dets[None, :], 0), axis=1)  # [H]

    handled = jnp.any(A & assigned_valid[:, None], axis=0)  # [D]
    spawn_unhandled = det_ok & ~handled  # [D]

    # Spawn order matches the reference: first the solver-assigned-but-
    # infeasible pairs in hypothesis order (:641-650), then unhandled
    # detections in detection order (:662-673).
    n0 = carry.n_hyp
    slot1_of_hyp = n0 + jnp.cumsum(spawn_from_hyp.astype(jnp.int32)) - 1
    n1 = n0 + jnp.sum(spawn_from_hyp.astype(jnp.int32))
    slot2_of_det = n1 + jnp.cumsum(spawn_unhandled.astype(jnp.int32)) - 1
    n2 = n1 + jnp.sum(spawn_unhandled.astype(jnp.int32))

    # Map spawn-1 (indexed by hypothesis) onto detections: detection d is
    # spawned from hypothesis h iff A[h, d] & spawn_from_hyp[h].
    det_to_slot = jnp.max(
        jnp.where(A & spawn_from_hyp[:, None], slot1_of_hyp[:, None], -1),
        axis=0,
    )  # [D]
    det_to_slot = jnp.where(spawn_unhandled, slot2_of_det, det_to_slot)

    # New value of state column `cam_idx`, built as full [H] vectors and
    # merged with a camera one-hot select (no dynamic-index scatter).
    # S[h', d]: detection d spawns INTO slot h' (overflow >= h matches no
    # slot and is dropped, counted below).
    S = det_to_slot[None, :] == jnp.arange(h, dtype=jnp.int32)[:, None]
    spawn_on = jnp.any(S, axis=1)  # [H]
    spawn_det = jnp.sum(jnp.where(S, dets[None, :], 0), axis=1)  # [H]

    cam1h = jnp.arange(c, dtype=jnp.int32) == cam_idx  # [C]
    old_col_det = jnp.max(
        jnp.where(cam1h[None, :], carry.det_slot, -1), axis=1
    )  # det_slot[:, cam_idx] (unobserved slots are -1, the column minimum)
    old_col_on = jnp.any(carry.cam_mask & cam1h[None, :], axis=1)

    new_col_det = jnp.where(
        extend,
        det_of_hyp,
        jnp.where(spawn_on, spawn_det, old_col_det),
    ).astype(jnp.int32)
    new_col_on = old_col_on | extend | spawn_on

    det_slot = jnp.where(cam1h[None, :], new_col_det[:, None], carry.det_slot)
    cam_mask = jnp.where(cam1h[None, :], new_col_on[:, None], carry.cam_mask)
    return _AssocCarry(
        det_slot=det_slot,
        cam_mask=cam_mask,
        n_hyp=jnp.minimum(n2, h).astype(jnp.int32),
        # n0 is already clipped to h, so this step's overflow is n2 - h.
        n_dropped=(
            carry.n_dropped + jnp.maximum(n2 - h, 0)
        ).astype(jnp.int32),
    )


# The Triton fold keeps [S, S] tiles in registers, S the power of two above
# max(H, D); "auto" uses it up to this width.
_TRITON_MAX_TILE = 128


def resolve_assignment_impl(impl: str, h: int, d: int) -> str:
    """The association fold `impl` stands for at H hypotheses x D
    detections on the default backend: "auto" is the Triton kernel on a GPU
    (up to _TRITON_MAX_TILE-wide tiles) and the cond-guarded XLA fold
    elsewhere; "cond_while" and "triton" are taken literally."""
    if impl != "auto":
        return impl
    if jax.default_backend() == "gpu" and max(h, d) < _TRITON_MAX_TILE:
        return "triton"
    return "cond_while"


def associate(
    kp_n: jnp.ndarray,
    cov_n: jnp.ndarray,
    det_score: jnp.ndarray,
    det_ok: jnp.ndarray,
    rig: CameraRig,
    config: FusionConfig,
    unroll_cameras: bool = False,
    interpret: bool = False,
) -> HypothesisSet:
    """Greedy cross-view association over all cameras.

    All epipolar math is hoisted out of the sequential camera loop: the
    per-observation costs between every detection pair are precomputed as
    one fused kernel (ops.epipolar.pairwise_association_costs), and each
    step only gathers them by the hypotheses' observation identities. The
    scan carries [H, C] index/mask arrays; observation data (keypoints,
    covariances, scores) is gathered once at the end.

    Args:
      kp_n: [C, D, J, 3] normalized keypoints (conf -1 where invalid).
      cov_n: [C, D, J, 3] normalized packed covariances.
      det_score: [C, D] per-detection person scores.
      det_ok: [C, D] detection usable (valid slot with enough keypoints).
      rig: camera rig (F used).
      interpret: run the "triton" fold in the Pallas interpreter (CPU
        tests); never implied by the backend.

    Returns:
      HypothesisSet with fixed max_hypotheses slots.
    """
    c, d, j, _ = kp_n.shape
    h = config.max_hypotheses
    dtype = kp_n.dtype

    # Pair-packed per-observation costs (C(C-1)/2 unordered pairs — the
    # greedy scan only ever pairs an earlier-camera observation with the
    # current camera's detections, so the lower triangle never exists),
    # scattered DIRECTLY into the [C2, C1*D1, D2] scan layout with a -1
    # sentinel marking unusable pairs — the step derives its four matmul
    # tables from this ONE block (see _associate_camera), so neither the
    # dense ordered [C,D,C,D] tensor (67 MB at 64x32) nor a 4x stacked
    # table ever materializes.
    cost_p, usable_p, iu, ju = epipolar.pairwise_association_costs_packed(
        kp_n, rig.F, config.min_kp_score
    )  # [Np, D1(obs cam iu), D2(det cam ju)]
    ctab = (
        jnp.full((c, c, d, d), -1.0, dtype)
        .at[ju, iu]
        .set(jnp.where(usable_p, cost_p, -1.0))
        .reshape(c, c * d, d)
    )  # [C2, C1*D1, D2]: the scan over the current camera slices axis 0.
    conf_obs = (det_score > 0.5).astype(dtype).reshape(c * d)  # (:352)

    if resolve_assignment_impl(config.assignment_impl, h, d) == "triton":
        # The whole C-step fold in one kernel program per frame (cost
        # assembly + JV + state update per camera): see
        # ops.association_triton. Bit-equal to the fold below.
        from smartedgesensor3dhumanpose_tpu.ops import association_triton

        fold = association_triton.make_associate_fold(
            interpret=interpret,
            h_cap=h,
            gate=float(config.max_epipolar_error),
            max_cost=float(config.max_cost),
            clip=_ASSIGN_COST_CLIP,
            tie_eps=_SOLVER_TIE_EPS,
            invalid_cost=_INVALID_DET_COST,
        )
        det_slot, n_hyp, n_dropped = fold(ctab, conf_obs, det_ok)
        carry = _AssocCarry(
            det_slot=det_slot,
            cam_mask=det_slot >= 0,
            n_hyp=n_hyp,
            n_dropped=n_dropped,
        )
        return _gather_hypotheses(
            carry, kp_n, cov_n, det_score, d, dtype
        )

    carry0 = _AssocCarry(
        det_slot=jnp.full((h, c), -1, jnp.int32),
        cam_mask=jnp.zeros((h, c), bool),
        n_hyp=jnp.zeros((), jnp.int32),
        n_dropped=jnp.zeros((), jnp.int32),
    )

    if unroll_cameras:
        carry = carry0
        for ci in range(c):
            carry = _associate_camera(
                carry, jnp.int32(ci), ctab[ci], conf_obs, det_ok[ci], config
            )
    else:
        def step(cy, xs):
            cam_idx, ctab_c, d_ok = xs
            return (
                _associate_camera(
                    cy, cam_idx, ctab_c, conf_obs, d_ok, config
                ),
                None,
            )

        carry, _ = jax.lax.scan(
            step,
            carry0,
            (jnp.arange(c, dtype=jnp.int32), ctab, det_ok),
            unroll=min(4, c),
        )

    return _gather_hypotheses(carry, kp_n, cov_n, det_score, d, dtype)


def _gather_hypotheses(
    carry: _AssocCarry,
    kp_n: jnp.ndarray,
    cov_n: jnp.ndarray,
    det_score: jnp.ndarray,
    d: int,
    dtype,
) -> HypothesisSet:
    """Materialize the hypothesis observations: select each (h, c) slot's
    detection data (the reference pushes copies into PersonHypothesis
    vectors as it goes; here it is one one-hot contraction at the end —
    a [H, C, D] x [C, D, ...] matmul instead of a serialized 2D gather)."""
    sel = (
        carry.det_slot[:, :, None] == jnp.arange(d, dtype=jnp.int32)
    ).astype(dtype)  # [H, C, D]; det_slot -1 rows are all-zero
    on = carry.cam_mask
    kp = jnp.where(
        on[..., None, None],
        linalg.heinsum("hcd,cdjk->hcjk", sel, kp_n),
        jnp.asarray([0.0, 0.0, -1.0], kp_n.dtype),  # conf -1: unobserved
    )
    cov = jnp.where(
        on[..., None, None], linalg.heinsum("hcd,cdjk->hcjk", sel, cov_n), 0.0
    )
    obs_score = jnp.where(
        on, linalg.heinsum("hcd,cd->hc", sel, det_score), 0.0
    )
    return HypothesisSet(
        kp=kp,
        cov=cov,
        cam_mask=on,
        obs_score=obs_score,
        n_hyp=carry.n_hyp,
        n_dropped=carry.n_dropped,
    )


def _select_outlier_drops(
    err0: jnp.ndarray,
    k: jnp.ndarray,
    rem_d2: jnp.ndarray,
    idx3: jnp.ndarray,
    loo_err: jnp.ndarray,
    view_mask: jnp.ndarray,
    config: FusionConfig,
) -> jnp.ndarray:
    """Choose which view (if any) to drop per joint (:748-838).

    Args:
      err0: [...] base weighted reprojection error.
      k: [...] valid view count.
      rem_d2: [..., 3] squared epipolar distance of the pair remaining after
        dropping each of the first three valid views
        (ops.epipolar.three_view_drop_scores; consumed only where k == 3).
      idx3: [..., 3] the first three valid view indices.
      loo_err: [..., C] reprojection error of the leave-view-c-out solution.
      view_mask: [..., C] bool.

    Returns:
      drop: [...] int32 camera index to drop, or -1.
    """
    big = jnp.asarray(3.0e38, err0.dtype)
    thresh = config.reproj_error_max_acceptable

    # --- exactly 3 views (:748-792): drop the view whose removal leaves the
    # smallest pairwise epipolar distance between the remaining two; accept
    # only if it beats err0^2 (the reference's initialization). idx3 is
    # ascending, so slot-argmin tie-breaks toward the lowest camera index
    # exactly like the reference's in-order sweep.
    slot3 = jnp.argmin(rem_d2, axis=-1)
    best3 = jnp.take_along_axis(idx3, slot3[..., None], axis=-1)[..., 0]
    best3_val = jnp.take_along_axis(rem_d2, slot3[..., None], axis=-1)[..., 0]
    # The reference casts err^2 to float for the initial bestDist.
    drop3 = jnp.where(best3_val < (err0 * err0), best3.astype(jnp.int32), -1)

    # --- 4+ views (:793-838): keep the leave-one-out solution if its error
    # improves on all tried so far AND is at least 10% better than err0.
    cand = view_mask & (loo_err < 0.9 * err0[..., None])
    loo_masked = jnp.where(cand, loo_err, big)
    best4 = jnp.argmin(loo_masked, axis=-1).astype(jnp.int32)
    found4 = jnp.any(cand, axis=-1)
    drop4 = jnp.where(found4, best4, -1)

    drop = jnp.where(
        (err0 > thresh) & (k == 3),
        drop3,
        jnp.where((err0 > thresh) & (k >= 4), drop4, -1),
    )
    return drop


def triangulate_hypotheses(
    hyps: HypothesisSet,
    rig: CameraRig,
    config: FusionConfig,
) -> Persons3D:
    """Triangulate every hypothesis into a 21-joint fusion skeleton.

    Covers the reference's per-hypothesis OpenMP loop (:676-982): view
    gathering, weighted DLT, outlier rejection, score down-weighting, UT
    covariance, limb-length covariance inflation, root/feet gates.
    """
    dtype = hyps.kp.dtype
    model = skeleton.input_model(config.pose_method)
    h, c, j, _ = hyps.kp.shape
    P = rig.P

    # Per-(hypothesis, joint) view mask: camera in hypothesis and keypoint
    # confident (>= threshold for triangulation, :725).
    kp_hj = jnp.swapaxes(hyps.kp, 1, 2)  # [H, J, C, 3]
    cov_hj = jnp.swapaxes(hyps.cov, 1, 2)  # [H, J, C, 3]
    conf = kp_hj[..., 2]
    view_mask = hyps.cam_mask[:, None, :] & (conf >= config.min_kp_score)
    k = jnp.sum(view_mask, axis=-1)  # [H, J]

    # Base triangulation (weighted) + error, built from per-view normal
    # matrix contributions so the leave-one-out batch below is a cheap
    # subtraction (T_c never rebuilt per drop candidate: the O(H*J*C*C)
    # coefficient tensors of a from-scratch rebuild do not materialize).
    T = triangulation.view_contribs(
        P, kp_hj, view_mask, weight_by_conf=True
    )  # [H, J, C, 4, 4]
    M0 = jnp.sum(T, axis=-3)
    xyz0 = triangulation.solve_normal(M0, k)
    err0 = triangulation.reprojection_error(xyz0, P, kp_hj, view_mask)

    # Leave-one-out solutions for every view (used by both rejection paths):
    # A^T A without view c is exactly M0 - T_c.
    loo_mask = view_mask[..., None, :] & ~jnp.eye(c, dtype=bool)  # [H,J,C,C]
    xyz_loo = triangulation.solve_normal(
        M0[..., None, :, :] - T, jnp.sum(loo_mask, axis=-1)
    )  # [H, J, C(drop), 3]
    err_loo = triangulation.reprojection_error(
        xyz_loo,
        P,
        jnp.broadcast_to(kp_hj[..., None, :, :], (h, j, c, c, 3)),
        loo_mask,
    )  # [H, J, C]

    rem_d2, idx3 = epipolar.three_view_drop_scores(rig.F, kp_hj, view_mask)

    drop = _select_outlier_drops(
        err0, k, rem_d2, idx3, err_loo, view_mask, config
    )
    dropped = drop >= 0
    drop_idx = jnp.where(dropped, drop, 0)

    final_mask = view_mask & ~(
        dropped[..., None]
        & (jnp.arange(c)[None, None, :] == drop_idx[..., None])
    )
    err = jnp.where(
        dropped,
        jnp.take_along_axis(err_loo, drop_idx[..., None], axis=-1)[..., 0],
        err0,
    )

    # Final positions: exactly the solution the reference publishes — the
    # base DLT, or the selected leave-one-out re-triangulation when a view
    # was dropped (:792,835). Both are already computed above, so this is a
    # select, not another solve. (An earlier revision re-solved with origin
    # recentering here; DLT's algebraic objective is not translation
    # invariant, so that legitimately lands millimeters away from the
    # reference's output — see tests/test_reference_parity_frame.py.)
    xyz = jnp.where(
        dropped[..., None],
        jnp.take_along_axis(
            xyz_loo, drop_idx[..., None, None], axis=-2
        )[..., 0, :],
        xyz0,
    )

    # Average score over the views used (:738, updated at :789,818-822).
    k_final = jnp.sum(final_mask, axis=-1)
    conf_sum = jnp.sum(jnp.where(final_mask, conf, 0.0), axis=-1)
    avg_score = conf_sum / jnp.maximum(k_final, 1).astype(dtype)
    # Still-large error: down-weight (:840-844).
    scale = jnp.where(
        err > config.reproj_error_max_acceptable,
        config.reproj_error_max_acceptable / jnp.maximum(err, 1e-20),
        1.0,
    )
    avg_score = avg_score * scale

    joint_valid = k >= 2  # triangulable at all (:734-736)

    # Unscented covariance on the final view set (:846-847).
    cov3d = covariance.triangulation_covariance(
        P, kp_hj, cov_hj, final_mask, xyz, kappa=config.ut_kappa
    )

    # ---- scatter 17 input joints into the 21-joint fusion layout ----
    to_fusion = jnp.asarray(model.to_fusion)
    kf = skeleton.NUM_FUSION_JOINTS
    score17 = jnp.where(joint_valid, avg_score, 0.0)
    xyz17 = jnp.where(joint_valid[..., None], xyz, 0.0)
    cov17 = jnp.where(joint_valid[..., None, None], cov3d, 0.0)
    xyz_f = jnp.zeros((h, kf, 3), dtype).at[:, to_fusion].set(xyz17)
    score_f = jnp.zeros((h, kf), dtype).at[:, to_fusion].set(score17)
    cov_f = jnp.zeros((h, kf, 3, 3), dtype).at[:, to_fusion].set(cov17)

    xyz_f, score_f, cov_f, n_pre, n_dropped, has_root = (
        _apply_limb_inflation_and_gates(xyz_f, score_f, cov_f, model, config)
    )
    return Persons3D(
        xyz=xyz_f,
        score=score_f,
        cov=cov_f,
        valid=_person_gate(
            xyz_f, score_f, n_pre, n_dropped, has_root, config
        ),
        person_id=-jnp.ones((h,), jnp.int32),
    )


def _apply_limb_inflation_and_gates(
    xyz_f: jnp.ndarray,
    score_f: jnp.ndarray,
    cov_f: jnp.ndarray,
    model: skeleton.InputModel,
    config: FusionConfig,
):
    """Limb-length covariance inflation (:861-883) + root-distance gate
    (:923-953). Operates on the fusion (21-joint) layout.

    Returns (xyz, score, cov, n_valid_pre_gate, n_dropped, has_root) — the
    counts feed the reference's person-level valid-keypoint arithmetic."""
    dtype = xyz_f.dtype
    to_fusion = np.asarray(model.to_fusion)
    parent17 = np.asarray(model.parent)
    limb_len = np.asarray(model.limb_length)
    limb_sig = np.asarray(model.limb_sigma)

    # For each of the 17 input joints, inflate its fusion slot when the
    # parent joint exists and the limb length is modeled.
    add_sigma = jnp.zeros_like(score_f)  # [H, K] sigma to add per joint
    for j17 in range(len(to_fusion)):
        fj = int(to_fusion[j17])
        pj17 = int(parent17[j17])
        if pj17 >= 0 and limb_len[j17] > 0:
            pf = int(to_fusion[pj17])
            dist = jnp.linalg.norm(xyz_f[:, fj] - xyz_f[:, pf], axis=-1)
            sig = (
                config.limb_cov_offset_sigma
                * (dist - float(limb_len[j17]))
                / float(limb_sig[j17])
            )
            active = (score_f[:, fj] > 0) & (score_f[:, pf] > 0)
            add_sigma = add_sigma.at[:, fj].add(jnp.where(active, sig, 0.0))
    # Shoulder special case for the COCO model (:875-882): no neck joint, so
    # gate the shoulder pair's mutual distance; inflates both shoulders.
    r17, l17 = model.shoulder_pair
    if r17 >= 0:
        rf, lf = int(to_fusion[r17]), int(to_fusion[l17])
        dist = jnp.linalg.norm(xyz_f[:, rf] - xyz_f[:, lf], axis=-1)
        sig = (
            config.limb_cov_offset_sigma
            * (dist - model.shoulder_dist)
            / model.shoulder_sigma
        )
        active = (score_f[:, rf] > 0) & (score_f[:, lf] > 0)
        sig = jnp.where(active, sig, 0.0)
        add_sigma = add_sigma.at[:, rf].add(sig)
        add_sigma = add_sigma.at[:, lf].add(sig)

    cov_f = cov_f + (add_sigma**2)[..., None, None] * jnp.eye(3, dtype=dtype)

    # Root-distance gate (:923-953): joints farther than the limit from the
    # root (MidHip, or hip-mean) are invalidated.
    n_pre = jnp.sum(score_f > 0, axis=1)
    root_xyz, root_score = _root_of(xyz_f, score_f)
    dist_root = jnp.linalg.norm(xyz_f - root_xyz[:, None, :], axis=-1)
    drop = (
        (root_score > 0)[:, None]
        & (score_f > 0)
        & (dist_root > config.max_joint_dist_to_root)
    )
    n_dropped = jnp.sum(drop, axis=1)
    score_f = jnp.where(drop, 0.0, score_f)
    xyz_f = jnp.where(drop[..., None], 0.0, xyz_f)
    cov_f = jnp.where(drop[..., None, None], 0.0, cov_f)
    return xyz_f, score_f, cov_f, n_pre, n_dropped, root_score > 0


def _root_of(
    xyz_f: jnp.ndarray, score_f: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Root joint: MidHip if present, else the mean of both hips
    (:923-935)."""
    midhip = skeleton.MIDHIP
    lhip, rhip = skeleton.LHIP, skeleton.RHIP
    have_mid = score_f[:, midhip] > 0
    have_hips = (score_f[:, lhip] > 0) & (score_f[:, rhip] > 0)
    hip_mean = 0.5 * (xyz_f[:, lhip] + xyz_f[:, rhip])
    hip_score = 0.5 * (score_f[:, lhip] + score_f[:, rhip])
    root_xyz = jnp.where(
        have_mid[:, None],
        xyz_f[:, midhip],
        jnp.where(have_hips[:, None], hip_mean, 0.0),
    )
    root_score = jnp.where(
        have_mid, score_f[:, midhip], jnp.where(have_hips, hip_score, 0.0)
    )
    return root_xyz, root_score


def _person_gate(
    xyz_f: jnp.ndarray,
    score_f: jnp.ndarray,
    n_pre: jnp.ndarray,
    n_dropped: jnp.ndarray,
    has_root: jnp.ndarray,
    config: FusionConfig,
) -> jnp.ndarray:
    """Person validity: feet-height plausibility (:955-966) and the
    valid-keypoint count gate (:968).

    The reference's counter starts at the triangulated-joint count and, when
    a root exists, is decremented once per dropped joint *and* once per
    originally-empty fusion slot (:938-952) — so the effective count is
    n_pre - n_dropped - (21 - n_pre). Without a root it stays n_pre. We
    reproduce that arithmetic exactly.
    """
    kf = score_f.shape[1]
    la, ra = skeleton.LANKLE, skeleton.RANKLE
    have_l = score_f[:, la] > 0
    have_r = score_f[:, ra] > 0
    feet_h = jnp.where(
        have_l & have_r,
        0.5 * (xyz_f[:, la, 2] + xyz_f[:, ra, 2]),
        jnp.where(
            have_l, xyz_f[:, la, 2], jnp.where(have_r, xyz_f[:, ra, 2], 0.0)
        ),
    )
    feet_ok = jnp.abs(feet_h) <= config.max_feet_height

    num_valid = jnp.where(has_root, n_pre - n_dropped - (kf - n_pre), n_pre)
    return feet_ok & (num_valid > config.min_num_valid_keypoints)


def merge_close_persons(persons: Persons3D, config: FusionConfig) -> Persons3D:
    """Greedy pairwise merge of skeletons closer than the threshold
    (:984-996).

    The reference sweeps all P(P-1)/2 ordered pairs sequentially. Here the
    sweep is restructured to P-1 sequential steps, one per *victim* slot j
    in ascending order, each step evaluating every keeper i<j vectorized
    and merging j into the first close one. This visits exactly the same
    state the lexicographic pair loop does: when the pair loop evaluates
    (i, j), keeper i's in-row updates come from pairs (i, j''<j) — already
    applied at earlier j-steps here — and j's own fate from rows m<i is
    settled within this j-step before keeper i is considered (the scan
    picks the FIRST close keeper). Slot j is never modified before it is
    consumed, because keepers only mutate in their own row (i, j'''>j),
    which the pair loop orders after (i, j) too. So the outputs are
    bit-identical while the sequential depth (the compile-time and launch
    hazard at max_hypotheses=40+) drops from O(P^2) to O(P).
    """
    p = persons.xyz.shape[0]
    if p < 2:
        return persons
    idx = jnp.arange(p)

    def step(state, j):
        xyz, score, cov, valid = state
        xj = xyz[j]
        sj = score[j]
        cj = cov[j]
        # Mean joint distance over joints valid in both (calc_3D_dist,
        # :392-408), for every candidate keeper i < j at once.
        joint_ok = (score > 0) & (sj > 0)  # [P, K]
        d = jnp.linalg.norm(xyz - xj[None], axis=-1)
        n = jnp.sum(joint_ok, axis=-1)
        mean_d = jnp.sum(jnp.where(joint_ok, d, 0.0), axis=-1) / jnp.maximum(
            n, 1
        )
        close = (
            valid
            & valid[j]
            & (idx < j)
            & (n > 0)
            & (mean_d < config.merge_dist_thresh)
        )
        do_merge = jnp.any(close)
        k = jnp.argmax(close)  # first close keeper (lexicographic order)

        # merge_persons (:410-423): score-weighted position, max score,
        # averaged covariance — for every joint where the combined score > 0.
        si = score[k]
        tot = si + sj
        any_score = tot > 0
        w_i = jnp.where(any_score, si / jnp.where(any_score, tot, 1.0), 0.0)
        merged_xyz = jnp.where(
            any_score[:, None],
            w_i[:, None] * xyz[k] + (1 - w_i)[:, None] * xj,
            xyz[k],
        )
        merged_score = jnp.where(any_score, jnp.maximum(si, sj), si)
        merged_cov = jnp.where(
            any_score[:, None, None], 0.5 * (cov[k] + cj), cov[k]
        )

        xyz = xyz.at[k].set(jnp.where(do_merge, merged_xyz, xyz[k]))
        score = score.at[k].set(jnp.where(do_merge, merged_score, score[k]))
        cov = cov.at[k].set(jnp.where(do_merge, merged_cov, cov[k]))
        valid = valid.at[j].set(jnp.where(do_merge, False, valid[j]))
        return (xyz, score, cov, valid), None

    state = (persons.xyz, persons.score, persons.cov, persons.valid)
    if p <= 16:
        # Short sweeps: unroll (removes loop-carry overhead; program stays
        # O(P) blocks, not O(P^2)).
        for j in range(1, p):
            state, _ = step(state, j)
    else:
        state, _ = jax.lax.scan(step, state, jnp.arange(1, p))
    xyz, score, cov, valid = state
    return persons._replace(xyz=xyz, score=score, cov=cov, valid=valid)


def fuse_frame(
    frame: Frame,
    rig: CameraRig,
    config: FusionConfig,
    unroll_cameras: bool = False,
    sharding_hook=None,
    with_stats: bool = False,
) -> Persons3D:
    """Full fusion of one synchronized frame: normalize -> associate ->
    triangulate -> gate -> merge (the whole skeleton_3d node per-frame
    path).

    with_stats: also return the [] int32 count of hypothesis spawns dropped
    because the fixed slot capacity overflowed — i.e. `(persons, n_dropped)`.

    sharding_hook: optional callable (tag, pytree) -> pytree applied at the
    stage boundaries so a caller can place GSPMD sharding constraints without
    this module knowing about meshes (see parallel.sharding.fuse_frame_
    sharded). Tags: "camera_inputs" (leading camera axis), "pre_association"
    (must replicate — the greedy scan consumes all cameras), "hypotheses"
    (leading hypothesis axis), "persons" (leading person axis).
    """
    hook = sharding_hook if sharding_hook is not None else lambda tag, t: t

    kp2d, cov2d, det_score, det_valid = hook(
        "camera_inputs",
        (frame.kp2d, frame.cov2d, frame.det_score, frame.det_valid),
    )
    kp_n, cov_n, kp_ok = cameras_lib.normalize_keypoints(
        kp2d, cov2d, rig.K, config.min_kp_score
    )
    # A detection participates only with more than half its keypoints valid
    # (:579,599) and a populated slot.
    enough = jnp.sum(kp_ok, axis=-1) > (config.num_input_joints // 2)
    det_ok = det_valid & enough

    # The association scan folds cameras sequentially into one hypothesis
    # set: it needs every camera's normalized keypoints — the hook inserts
    # the all_gather here (small: C x D x J x 3 floats, SURVEY section 2).
    kp_n, cov_n, det_score, det_ok = hook(
        "pre_association", (kp_n, cov_n, det_score, det_ok)
    )

    hyps = associate(
        kp_n, cov_n, det_score, det_ok, rig, config,
        unroll_cameras=unroll_cameras,
    )
    # The per-hypothesis triangulation/covariance work (the FLOP-heavy part)
    # distributes over the hypothesis axis.
    hyps = hook("hypotheses", hyps)
    # Hypotheses need >= 2 observations to triangulate (:684).
    persons = triangulate_hypotheses(hyps, rig, config)
    active = jnp.arange(persons.valid.shape[0]) < hyps.n_hyp
    n_obs = jnp.sum(hyps.cam_mask, axis=-1)
    persons = persons._replace(valid=persons.valid & active & (n_obs >= 2))
    persons = hook("persons", persons)
    merged = merge_close_persons(persons, config)
    if with_stats:
        return merged, hyps.n_dropped
    return merged
