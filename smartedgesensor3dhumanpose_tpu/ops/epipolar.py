"""Epipolar geometry kernels for cross-view data association.

Vectorizes the reference's calcCost (skeleton_3d_triang_mult_node.cpp:335-390)
— the symmetric epipolar point-line distance between a person hypothesis'
accumulated observations and a candidate detection, averaged over shared
confident joints and over observations, with the fractional veto
accumulation — into one einsum-shaped program over
(hypotheses x observations x detections x joints).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smartedgesensor3dhumanpose_tpu.ops import linalg


def symmetric_epipolar_distance(
    F: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray
) -> jnp.ndarray:
    """Symmetric point-to-epipolar-line distance d1 + d2.

    d1 = |p2 . (F p1)| / ||(F p1)_xy||, d2 = |p1 . (F^T p2)| / ||(F^T p2)_xy||
    (reference :355-362).

    Args:
      F: [..., 3, 3] fundamental matrices (view of p1 -> view of p2).
      p1, p2: [..., 2] normalized image points.

    Returns:
      [...] distances.
    """
    p1h = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], axis=-1)
    p2h = jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], axis=-1)
    l1 = linalg.heinsum("...ij,...j->...i", F, p1h)  # epipolar line of p1 in view 2
    l2 = linalg.heinsum("...ji,...j->...i", F, p2h)  # F^T p2: line of p2 in view 1
    n1 = jnp.sqrt(l1[..., 0] ** 2 + l1[..., 1] ** 2)
    n2 = jnp.sqrt(l2[..., 0] ** 2 + l2[..., 1] ** 2)
    d1 = jnp.abs(linalg.heinsum("...i,...i->...", p2h, l1)) / jnp.where(
        n1 > 0, n1, 1.0
    )
    d2 = jnp.abs(linalg.heinsum("...i,...i->...", p1h, l2)) / jnp.where(
        n2 > 0, n2, 1.0
    )
    return d1 + d2


def association_cost(
    hyp_kp: jnp.ndarray,
    hyp_cam_mask: jnp.ndarray,
    hyp_obs_score: jnp.ndarray,
    det_kp: jnp.ndarray,
    det_valid: jnp.ndarray,
    F_to_det: jnp.ndarray,
    min_kp_score: float,
    max_epipolar_error: float,
    max_cost: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hypothesis x detection epipolar cost matrix with veto flags.

    Replicates calcCost (:335-390): per observation (camera already in the
    hypothesis), average the symmetric epipolar distance over joints confident
    in both views; average those per-observation costs over observations with
    at least one shared joint. An observation votes to veto when its cost
    exceeds the gate and it is either confident (score > 0.5) or the only
    observation; the pairing is vetoed when the accumulated vote exceeds
    1 - 1/(2 n_obs). Pairings with no usable observation get max_cost + veto.

    Args:
      hyp_kp: [H, C, J, 3] per-hypothesis per-camera normalized keypoints
        (x, y, conf; conf < 0 where unobserved).
      hyp_cam_mask: [H, C] bool — cameras contributing to each hypothesis.
      hyp_obs_score: [H, C] per-observation person score.
      det_kp: [D, J, 3] candidate detections in the current camera.
      det_valid: [D] bool.
      F_to_det: [C, 3, 3] fundamental matrices from each (potential
        observation) camera to the current detection camera.
      min_kp_score: joint confidence gate (g_triangulation_threshold).
      max_epipolar_error: veto / feasibility gate (g_max_epipolar_error).
      max_cost: MAX_COSTS.

    Returns:
      (cost [H, D], veto [H, D] bool).
    """
    # Joint usable in both views: [H, C, D, J].
    hyp_conf_ok = hyp_kp[..., 2] > min_kp_score  # [H, C, J]
    det_conf_ok = det_kp[..., 2] > min_kp_score  # [D, J]
    both_ok = hyp_conf_ok[:, :, None, :] & det_conf_ok[None, None, :, :]

    # Distances: broadcast hyp [H, C, 1, J, 2] vs det [1, 1, D, J, 2] with
    # F [1, C, 1, 1, 3, 3].
    d = symmetric_epipolar_distance(
        F_to_det[None, :, None, None],
        hyp_kp[:, :, None, :, :2],
        jnp.broadcast_to(
            det_kp[None, None, :, :, :2],
            hyp_kp.shape[:2] + det_kp.shape[:2] + (2,),
        ),
    )  # [H, C, D, J]

    n_joints = jnp.sum(both_ok, axis=-1)  # [H, C, D]
    dist_sum = jnp.sum(jnp.where(both_ok, d, 0.0), axis=-1)
    obs_cost = dist_sum / jnp.where(n_joints > 0, n_joints, 1)  # [H, C, D]

    obs_in_hyp = hyp_cam_mask  # [H, C]
    obs_used = obs_in_hyp[:, :, None] & (n_joints > 0)  # [H, C, D]
    n_obs_in_hyp = jnp.sum(obs_in_hyp, axis=-1)  # [H]
    n_obs_used = jnp.sum(obs_used, axis=1)  # [H, D] (sum over C)

    total = jnp.sum(jnp.where(obs_used, obs_cost, 0.0), axis=1)  # [H, D]
    cost = total / jnp.where(n_obs_used > 0, n_obs_used, 1)

    # Veto accumulation (:344-381). Only confident observations (or a
    # single-observation hypothesis) vote; each vote adds 1/n_obs_in_hyp.
    confident = (hyp_obs_score > 0.5)[:, :, None] | (
        n_obs_in_hyp[:, None, None] == 1
    )
    vote = obs_used & (obs_cost > max_epipolar_error) & confident
    n_obs_f = jnp.maximum(n_obs_in_hyp, 1).astype(cost.dtype)
    tmp_veto = jnp.sum(vote, axis=1).astype(cost.dtype) / n_obs_f[:, None]
    tolerance = 1.0 - 1.0 / (2.0 * n_obs_f)
    veto = tmp_veto > tolerance[:, None]

    unusable = (n_obs_used == 0) | (n_obs_in_hyp[:, None] == 0)
    cost = jnp.where(unusable, max_cost, cost)
    veto = veto | unusable

    # Invalid detection slots are never joinable.
    cost = jnp.where(det_valid[None, :], cost, max_cost)
    veto = veto | ~det_valid[None, :]
    return cost, veto


def pairwise_association_costs(
    kp: jnp.ndarray,
    F: jnp.ndarray,
    min_kp_score: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """calcCost's per-observation term for EVERY ordered detection pair.

    The greedy association folds cameras in sequentially, and each step's
    hypothesis x detection cost is a mean of per-observation costs — where
    every observation is itself one of the frame's detections. So the
    per-observation term between detection (c1, d1) and detection (c2, d2)
    (symmetric epipolar point-line distance averaged over joints confident
    in both, reference :344-366) can be computed ONCE for the whole frame.

    The heavy [*, D, D, J] reduction runs only over the C(C-1)/2 UNORDERED
    camera pairs (half the ordered work): the symmetric distance is
    invariant under swapping the pair's roles — term1 + term2 with F[c1,c2]
    equals term2' + term1' with F[c2,c1] (each term is scale-invariant in F
    and F[c2,c1] is proportional to F[c1,c2]^T; IEEE addition is
    commutative, so the mirrored entry is the packed value bit-exactly).
    The reference itself evaluates both orientations from the one
    canonically-oriented matrix (calcCost :350-362 via get_fundamental_idx).
    The 3-vector dots are written componentwise so XLA fuses the pair-packed
    [Np, D, D, J] program straight into the joint reduction.

    Args:
      kp: [C, D, J, 3] normalized keypoints (x, y, conf).
      F: [C, C, 3, 3] fundamental matrices (i -> j).
      min_kp_score: joint confidence gate (g_triangulation_threshold).

    Returns:
      (pair_cost [C, D, C, D], pair_usable [C, D, C, D] bool): the
      per-observation cost of pairing observation (c1, d1) with a candidate
      detection (c2, d2), and whether they share any confident joint.
      Entries with c1 == c2 are zero (never gathered).
    """
    c, dd, j, _ = kp.shape
    if c < 2:
        z = jnp.zeros((c, dd, c, dd), kp.dtype)
        return z, jnp.zeros((c, dd, c, dd), bool)
    cost_p, usable_p, iu, ju = pairwise_association_costs_packed(
        kp, F, min_kp_score
    )
    # Scatter the packed upper triangle into the dense ordered layout and
    # mirror (bit-exact, see above). The diagonal stays zero/unusable.
    pair_cost = jnp.zeros((c, dd, c, dd), cost_p.dtype)
    pair_cost = pair_cost.at[iu, :, ju, :].set(cost_p)
    pair_cost = pair_cost + jnp.transpose(pair_cost, (2, 3, 0, 1))
    usable = jnp.zeros((c, dd, c, dd), bool)
    usable = usable.at[iu, :, ju, :].set(usable_p)
    usable = usable | jnp.transpose(usable, (2, 3, 0, 1))
    return pair_cost, usable


def pairwise_association_costs_packed(
    kp: jnp.ndarray,
    F: jnp.ndarray,
    min_kp_score: float,
):
    """Pair-packed form of `pairwise_association_costs`.

    Returns (cost [Np, D, D], usable [Np, D, D], iu, ju) where
    (iu[p], ju[p]) enumerate the C(C-1)/2 unordered camera pairs with
    iu < ju (NumPy triu order) and entry [p, d1, d2] is the per-observation
    cost between detection (iu[p], d1) and (ju[p], d2).
    """
    c, dd, j, _ = kp.shape
    iu, ju = np.triu_indices(c, k=1)  # [Np] static pair index tables
    # A bf16 product here is ~2e3x less accurate; the reduction stays in
    # the input dtype.
    # Joint-major layout [*, J, D]: the heavy [Np, J, D1, D2] product below
    # then carries the detection axes minor (D1 sublanes x D2 lanes) instead
    # of the 17-joint axis — measurably better VPU lane utilization than the
    # J-minor [Np, D1, D2, J] form (~1.25x on the 64-cam config), and the
    # joint reduction becomes a batch-axis sum XLA fuses just the same.
    xT = jnp.swapaxes(kp[..., 0], -1, -2)  # [C, J, D]
    yT = jnp.swapaxes(kp[..., 1], -1, -2)
    conf_okT = jnp.swapaxes(kp[..., 2], -1, -2) > min_kp_score

    x1, y1 = xT[iu], yT[iu]  # [Np, J, D1]
    x2, y2 = xT[ju], yT[ju]  # [Np, J, D2]
    Fp = F[iu, ju]  # [Np, 3, 3]

    # Epipolar line of (c1, d1, j) in camera c2: l1 = Fp @ [x1, y1, 1];
    # componentwise, shapes [Np, J, D1].
    def line(f0, f1, f2, xs, ys):
        return (
            f0[:, None, None] * xs + f1[:, None, None] * ys
            + f2[:, None, None]
        )

    l10 = line(Fp[:, 0, 0], Fp[:, 0, 1], Fp[:, 0, 2], x1, y1)
    l11 = line(Fp[:, 1, 0], Fp[:, 1, 1], Fp[:, 1, 2], x1, y1)
    l12 = line(Fp[:, 2, 0], Fp[:, 2, 1], Fp[:, 2, 2], x1, y1)
    den1 = l10**2 + l11**2  # [Np, J, D1]
    # Guarded rsqrt: one op instead of sqrt+divide (this reduction is the
    # VPU-bound part of the frame); degenerate zero-norm lines keep the
    # raw |numerator| like the division path did. The 1/||l_xy|| factor is
    # folded into the line coefficients on the SMALL [Np, J, D] tensors, so
    # the [Np, J, D1, D2] product needs no per-element normalization
    # multiply (|a| * s == |a * s| for s >= 0 up to one rounding).
    inv1 = jnp.where(den1 > 0, jax.lax.rsqrt(den1), 1.0)
    l10, l11, l12 = l10 * inv1, l11 * inv1, l12 * inv1

    # Line of (c2, d2, j) back in camera c1: l2 = Fp^T @ [x2, y2, 1].
    l20 = line(Fp[:, 0, 0], Fp[:, 1, 0], Fp[:, 2, 0], x2, y2)
    l21 = line(Fp[:, 0, 1], Fp[:, 1, 1], Fp[:, 2, 1], x2, y2)
    l22 = line(Fp[:, 0, 2], Fp[:, 1, 2], Fp[:, 2, 2], x2, y2)
    den2 = l20**2 + l21**2  # [Np, J, D2]
    inv2 = jnp.where(den2 > 0, jax.lax.rsqrt(den2), 1.0)
    l20, l21, l22 = l20 * inv2, l21 * inv2, l22 * inv2

    # num1[p,j,d1,d2] = p2 . (l1 / ||l1_xy||), num2 = p1 . (l2 / ||l2_xy||)
    # (reference :357-360).
    num1 = (
        x2[:, :, None, :] * l10[..., None]
        + y2[:, :, None, :] * l11[..., None]
        + l12[..., None]
    )
    num2 = (
        x1[..., None] * l20[:, :, None, :]
        + y1[..., None] * l21[:, :, None, :]
        + l22[:, :, None, :]
    )
    d = jnp.abs(num1) + jnp.abs(num2)  # [Np, J, D1, D2]

    both_ok = conf_okT[iu][..., None] & conf_okT[ju][:, :, None, :]
    n_joints = jnp.sum(both_ok, axis=1)  # [Np, D1, D2]
    dist_sum = jnp.sum(jnp.where(both_ok, d, 0.0), axis=1)
    cost_p = dist_sum / jnp.where(n_joints > 0, n_joints, 1)
    return cost_p, n_joints > 0, iu, ju


def three_view_drop_scores(
    F: jnp.ndarray,
    kp: jnp.ndarray,
    view_mask: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-drop remaining pairwise epipolar d^2 for the EXACTLY-3-view case.

    The 3-view outlier rejection (reference :748-792) needs, for each of the
    3 valid views, the squared symmetric epipolar distance between the
    remaining two. Only joints with k == 3 consume it, so instead of the
    full [..., C, C] pair matrix (the O(batch * C^2) tensor that dominated
    the scaled config's triangulation stage), gather the first three valid
    view indices and evaluate exactly three pairs.

    Args:
      F: [C, C, 3, 3] fundamental matrices.
      kp: [..., C, 3] normalized keypoints.
      view_mask: [..., C] bool.

    Returns:
      (rem_d2 [..., 3], idx3 [..., 3]): rem_d2[v] is the d^2 of the pair
      remaining after dropping the v-th valid view; idx3 are the first three
      valid view indices (ascending; arbitrary where k < 3 — callers gate on
      k == 3).
    """
    # First three valid view indices, ascending: the v-th valid view is the
    # argmax of (cumulative-count == v) & mask along the camera axis.
    pos = jnp.cumsum(view_mask, axis=-1) - 1  # [..., C]

    def nth_valid(v):
        hit = view_mask & (pos == v)
        return jnp.where(
            jnp.any(hit, axis=-1), jnp.argmax(hit, axis=-1), 0
        ).astype(jnp.int32)

    idx3 = jnp.stack([nth_valid(0), nth_valid(1), nth_valid(2)], axis=-1)

    def gather_kp(i):
        return jnp.take_along_axis(kp, i[..., None, None], axis=-2)[..., 0, :]

    p = [gather_kp(idx3[..., v]) for v in range(3)]  # 3 x [..., 3]

    def pair_d2(ia, ib, pa, pb):
        # Canonical orientation F[min, max] — the same values the dense
        # symmetrized pair matrix carried (and the reference's
        # get_fundamental_idx canonicalization).
        lo = jnp.minimum(ia, ib)
        hi = jnp.maximum(ia, ib)
        Fp = F[lo, hi]  # [..., 3, 3] batched gather
        p1 = jnp.where((ia <= ib)[..., None], pa, pb)
        p2 = jnp.where((ia <= ib)[..., None], pb, pa)
        one = jnp.ones_like(p1[..., :1])
        p1h = jnp.concatenate([p1[..., :2], one], axis=-1)
        p2h = jnp.concatenate([p2[..., :2], one], axis=-1)
        l1 = linalg.heinsum("...ij,...j->...i", Fp, p1h)
        l2 = linalg.heinsum("...ji,...j->...i", Fp, p2h)
        num1 = linalg.heinsum("...i,...i->...", p2h, l1)
        num2 = linalg.heinsum("...i,...i->...", p1h, l2)
        den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
        den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
        return num1**2 / jnp.where(den1 > 0, den1, 1.0) + num2**2 / jnp.where(
            den2 > 0, den2, 1.0
        )

    d2_01 = pair_d2(idx3[..., 0], idx3[..., 1], p[0], p[1])
    d2_02 = pair_d2(idx3[..., 0], idx3[..., 2], p[0], p[2])
    d2_12 = pair_d2(idx3[..., 1], idx3[..., 2], p[1], p[2])
    # Dropping valid view v leaves the other two's pair.
    rem_d2 = jnp.stack([d2_12, d2_02, d2_01], axis=-1)
    return rem_d2, idx3


def pairwise_joint_epipolar_sq(
    F: jnp.ndarray,
    kp: jnp.ndarray,
    view_mask: jnp.ndarray,
) -> jnp.ndarray:
    """Squared symmetric epipolar distance between every pair of views.

    Used by the 3-view outlier rejection (:748-792): for views (a, b) of the
    same joint, d^2 = num1^2/||l1_xy||^2 + num2^2/||l2_xy||^2 where
    l1 = F_ab p_a, l2 = F_ab^T p_b. Invalid pairs are zero.

    Args:
      F: [C, C, 3, 3] fundamental matrices.
      kp: [..., C, 3] normalized keypoints.
      view_mask: [..., C] bool.

    Returns:
      [..., C, C] symmetric matrix of squared distances (diagonal zero).
    """
    one = jnp.ones_like(kp[..., :1])
    ph = jnp.concatenate([kp[..., :2], one], axis=-1)  # [..., C, 3]
    l1 = linalg.heinsum("abij,...aj->...abi", F, ph)  # line of p_a in view b
    l2 = linalg.heinsum("abji,...bj->...abi", F, ph)  # F^T p_b: line in view a
    num1 = linalg.heinsum("...bi,...abi->...ab", ph, l1)
    num2 = linalg.heinsum("...ai,...abi->...ab", ph, l2)
    den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    d2 = num1**2 / jnp.where(den1 > 0, den1, 1.0) + num2**2 / jnp.where(
        den2 > 0, den2, 1.0
    )
    pair_ok = view_mask[..., :, None] & view_mask[..., None, :]
    eye = jnp.eye(kp.shape[-2], dtype=bool)
    d2 = jnp.where(pair_ok & ~eye, d2, 0.0)
    # Symmetrize: the formula is already symmetric in exact arithmetic; use
    # the upper triangle mirrored to make it exactly so.
    upper = jnp.triu(d2)
    return upper + jnp.swapaxes(upper, -1, -2)
