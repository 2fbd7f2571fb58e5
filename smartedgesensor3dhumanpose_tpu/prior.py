"""Skeleton-model smoothing: batched Levenberg-Marquardt factor optimization.

Replaces the reference pose_prior node's gtsam pipeline
(pose_prior_mult_node.cpp): per person, a nonlinear factor graph of

* identity-Jacobian 3D position priors on every measured joint (UnaryFactor,
  :126-145), with the root's covariance shrunk by root_sigma_factor^2 to pin
  the skeleton's global position (:690),
* bone-length range factors between measured joint pairs (addBinaryFactors,
  :384-481; tables in skeleton.py),

optimized by Levenberg-Marquardt from a warm start (previous track estimate,
setInitialState :483-503), with posterior marginals from the final Hessian
(:760-767).

The reference runs gtsam once per person on OpenMP threads; here the state is
a fixed [21, 3] block vector per person, the (dense, 63x63) normal equations
are assembled by block scatter, and the whole LM loop is vmapped over the
person axis inside one `lax.while_loop`. Unmeasured joints get a decoupled
unit anchor at the origin so the padded problem's solution and marginals on
measured joints equal the reference's variable-size graph exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smartedgesensor3dhumanpose_tpu import skeleton
from smartedgesensor3dhumanpose_tpu.config import PriorConfig
from smartedgesensor3dhumanpose_tpu.ops import linalg, tree_solve
from smartedgesensor3dhumanpose_tpu.types import Persons3D

_K = skeleton.NUM_FUSION_JOINTS


def _spd_solve(h_eq: jnp.ndarray, rhs: jnp.ndarray):
    """Batched SPD solve of the equilibrated system; rhs [P, N, R].

    XLA's cholesky/triangular-solve custom calls: 64 sequential
    masked-tile elimination steps in a hand-written kernel do not beat the
    blocked custom call at this size.
    """
    chol = jax.scipy.linalg.cholesky(h_eq, lower=True)
    return jax.scipy.linalg.cho_solve((chol, True), rhs)


class GraphInputs(NamedTuple):
    """Per-person normalized measurement set (the reference's `measurements`
    Values + noise models)."""

    meas: jnp.ndarray        # [P, K, 3] root-centered, height-normalized
    active: jnp.ndarray      # [P, K] bool — joint is measured
    inv_cov: jnp.ndarray     # [P, K, 3, 3] whitening information matrices
    bone_active: jnp.ndarray  # [P, B] bool
    root_xyz: jnp.ndarray    # [P, 3] centering root (base frame)
    root_score: jnp.ndarray  # [P]
    neck_score: jnp.ndarray  # [P]
    height: jnp.ndarray      # [P] normalization scale
    score_out: jnp.ndarray   # [P, K] output scores (max(min_score, raw))
    num_meas: jnp.ndarray    # [P] int32


def _unpack_cov(cov: jnp.ndarray) -> jnp.ndarray:
    return cov  # covariances already stored as full 3x3 in Persons3D


def _safe_inv3(a: jnp.ndarray) -> jnp.ndarray:
    """Batched 3x3 inverse via adjugate with a singularity guard."""
    m = a
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = jnp.stack(
        [
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    ok = jnp.abs(det) > 1e-30
    inv = adj / jnp.where(ok, det, 1.0)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=a.dtype), a.shape)
    return jnp.where(ok[..., None, None], inv, eye)


def build_graph_inputs(persons: Persons3D, cfg: PriorConfig) -> GraphInputs:
    """Root/neck synthesis, height normalization, and measurement packing
    (reference :626-741)."""
    dtype = persons.xyz.dtype
    xyz = persons.xyz
    score = persons.score
    cov = persons.cov
    p = xyz.shape[0]

    if cfg.pose_method == "h36m":
        root_xyz = xyz[:, skeleton.MIDHIP]
        root_score = score[:, skeleton.MIDHIP]
        root_cov = cov[:, skeleton.MIDHIP]
        neck_xyz = xyz[:, skeleton.NECK]
        neck_score = score[:, skeleton.NECK]
        neck_cov = cov[:, skeleton.NECK]
    else:
        # Root = hip mean, synthesized when both hips have any score (> 0,
        # :637-645); Neck = shoulder mean likewise (:647-655).
        lh, rh = skeleton.LHIP, skeleton.RHIP
        ls, rs = skeleton.LSHOULDER, skeleton.RSHOULDER
        have_hips = (score[:, lh] > 0) & (score[:, rh] > 0)
        root_xyz = jnp.where(
            have_hips[:, None], 0.5 * (xyz[:, lh] + xyz[:, rh]), 0.0
        )
        root_score = jnp.where(
            have_hips, 0.5 * (score[:, lh] + score[:, rh]), 0.0
        )
        root_cov = 0.5 * (cov[:, lh] + cov[:, rh])
        have_sh = (score[:, ls] > 0) & (score[:, rs] > 0)
        neck_xyz = jnp.where(
            have_sh[:, None], 0.5 * (xyz[:, ls] + xyz[:, rs]), 0.0
        )
        neck_score = jnp.where(
            have_sh, 0.5 * (score[:, ls] + score[:, rs]), 0.0
        )
        neck_cov = 0.5 * (cov[:, ls] + cov[:, rs])

    root_ok = root_score > cfg.min_score
    # Height (only defined when the root is usable, :658-668).
    if cfg.normalize_by_height:
        neck_ok = neck_score > cfg.min_score
        h = jnp.where(
            neck_ok,
            jnp.linalg.norm(neck_xyz - root_xyz, axis=-1),
            cfg.default_height,
        )
        height = jnp.where(root_ok, h, 1.0)
    else:
        height = jnp.ones((p,), dtype)
    h2 = (height * height)[:, None, None]

    # Center on the synthesized root even when it is below the score gate
    # (the reference centers on the default-constructed root, :714).
    center = root_xyz

    meas = jnp.zeros((p, _K, 3), dtype)
    active = jnp.zeros((p, _K), bool)
    cov_n = jnp.broadcast_to(
        jnp.eye(3, dtype=dtype), (p, _K, 3, 3)
    )
    score_out = jnp.zeros((p, _K), dtype)

    # Regular joints (all but MidHip; Neck handled below for COCO).
    reg = (score > cfg.min_score).at[:, skeleton.MIDHIP].set(False)
    if cfg.pose_method != "h36m":
        reg = reg.at[:, skeleton.NECK].set(False)
    meas_all = (xyz - center[:, None, :]) / height[:, None, None]
    meas = jnp.where(reg[..., None], meas_all, meas)
    active = active | reg
    cov_n = jnp.where(reg[..., None, None], cov / h2[..., None], cov_n)
    score_out = jnp.where(
        reg, jnp.maximum(cfg.min_score, score), score_out
    )

    # Root measurement at the origin with shrunken covariance (:690-693).
    rho2 = cfg.root_sigma_factor**2
    root_cov_n = root_cov / h2 / rho2
    meas = meas.at[:, skeleton.MIDHIP].set(0.0)
    active = active.at[:, skeleton.MIDHIP].set(root_ok)
    cov_n = cov_n.at[:, skeleton.MIDHIP].set(
        jnp.where(root_ok[:, None, None], root_cov_n, jnp.eye(3, dtype=dtype))
    )
    score_out = score_out.at[:, skeleton.MIDHIP].set(
        jnp.where(root_ok, jnp.maximum(cfg.min_score, root_score), 0.0)
    )

    # Synthesized neck for the COCO model (:721-737).
    if cfg.pose_method != "h36m":
        neck_ok2 = neck_score > cfg.min_score
        neck_m = (neck_xyz - center) / height[:, None]
        meas = meas.at[:, skeleton.NECK].set(
            jnp.where(neck_ok2[:, None], neck_m, 0.0)
        )
        active = active.at[:, skeleton.NECK].set(neck_ok2)
        cov_n = cov_n.at[:, skeleton.NECK].set(
            jnp.where(
                neck_ok2[:, None, None],
                neck_cov / h2,
                jnp.eye(3, dtype=dtype),
            )
        )
        score_out = score_out.at[:, skeleton.NECK].set(
            jnp.where(neck_ok2, jnp.maximum(cfg.min_score, neck_score), 0.0)
        )

    # A person with no valid slot contributes nothing (:739-741).
    active = active & persons.valid[:, None]
    score_out = jnp.where(active, score_out, 0.0)
    num_meas = jnp.sum(active, axis=-1).astype(jnp.int32)

    inv_cov = jnp.where(
        active[..., None, None],
        _safe_inv3(cov_n),
        jnp.broadcast_to(jnp.eye(3, dtype=dtype), cov_n.shape),
    )

    # Bone factors: both endpoints measured; the COCO spine bone only when
    # the Belly is unmeasured (:422-423,470-471).
    bone_i, bone_j, _, _ = skeleton.bone_tables(
        cfg.normalize_by_height, cfg.effective_limb_sigma_factor
    )
    bi = jnp.asarray(bone_i)
    bj = jnp.asarray(bone_j)
    bone_active = active[:, bi] & active[:, bj]
    spine = skeleton.SPINE_BONE_IDX
    bone_active = bone_active.at[:, spine].set(
        bone_active[:, spine] & ~active[:, skeleton.BELLY]
    )

    return GraphInputs(
        meas=meas,
        active=active,
        inv_cov=inv_cov,
        bone_active=bone_active,
        root_xyz=center,
        root_score=root_score,
        neck_score=neck_score,
        height=height,
        score_out=score_out,
        num_meas=num_meas,
    )


def _residual_terms(
    x: jnp.ndarray,
    g_in: GraphInputs,
    bone_len: jnp.ndarray,
    bone_w: jnp.ndarray,
    bi: jnp.ndarray,
    bj: jnp.ndarray,
):
    """Shared residual ingredients for the dense / tree linearizations and
    the error evaluation: whitened unary residuals, bone directions and
    whitened bone residuals, and the total error.

    Returns (w_r [P,K,3], act [P,K], err [P], u [P,B,3], r_b [P,B],
    wb [P,B])."""
    dtype = x.dtype
    # Unary factors: r = x - m, whitened by inv_cov.
    r_u = x - g_in.meas  # [P, K, 3]
    w_r = linalg.heinsum("pkij,pkj->pki", g_in.inv_cov, r_u)
    act = g_in.active.astype(dtype)
    err = 0.5 * jnp.sum(act * linalg.heinsum("pki,pki->pk", r_u, w_r), axis=-1)
    # Bone range factors: r = ||xi - xj|| - L along the unit direction u.
    d = x[:, bi] - x[:, bj]
    n = jnp.linalg.norm(d, axis=-1)
    safe = n > 1e-12
    u = d / jnp.where(safe, n, 1.0)[..., None]
    r_b = jnp.where(safe, n, 0.0) - bone_len  # [P, B]
    wb = g_in.bone_active.astype(dtype) * bone_w  # [P, B] = 1/sigma^2
    err = err + 0.5 * jnp.sum(wb * r_b * r_b, axis=-1)
    return w_r, act, err, u, r_b, wb


def _signed_incidence(bi: jnp.ndarray, bj: jnp.ndarray, dtype) -> jnp.ndarray:
    """Static signed incidence S[b, k] = +1 at bi[b], -1 at bj[b]."""
    b_cnt = bi.shape[0]
    return (
        jnp.zeros((b_cnt, _K), dtype)
        .at[jnp.arange(b_cnt), bi]
        .add(1.0)
        .at[jnp.arange(b_cnt), bj]
        .add(-1.0)
    )


def _linearize(
    x: jnp.ndarray,
    g_in: GraphInputs,
    bone_len: jnp.ndarray,
    bone_w: jnp.ndarray,
    bi: jnp.ndarray,
    bj: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Assemble H [P, K, 3, K, 3], gradient g [P, K, 3] and error [P].

    The block structure is materialized with static one-hot/incidence
    einsums rather than scatters (scatters into a 63x63 tensor would
    dominate the LM iteration; the incidence form is two tiny contractions).
    """
    dtype = x.dtype
    w_r, act, err, u, r_b, wb = _residual_terms(
        x, g_in, bone_len, bone_w, bi, bj
    )
    g = act[..., None] * w_r  # [P, K, 3]
    # Diagonal blocks: the measured joints' information matrices; unmeasured
    # joints keep their decoupled unit anchor (build_graph_inputs stores
    # identity there) — masking them to zero would make H singular and the
    # float32 factorization NaN out.
    eye_k = jnp.eye(_K, dtype=dtype)
    h = linalg.heinsum("kl,pkij->pkilj", eye_k, g_in.inv_cov)

    inc = _signed_incidence(bi, bj, dtype)
    g_b = (wb * r_b)[..., None] * u  # [P, B, 3]
    g = g + linalg.heinsum("bk,pbi->pki", inc, g_b)

    uu = wb[..., None, None] * u[..., :, None] * u[..., None, :]  # [P,B,3,3]
    h = h + linalg.heinsum("bk,bl,pbij->pkilj", inc, inc, uu)
    return h, g, err


def _error_only(
    x: jnp.ndarray,
    g_in: GraphInputs,
    bone_len: jnp.ndarray,
    bone_w: jnp.ndarray,
    bi: jnp.ndarray,
    bj: jnp.ndarray,
) -> jnp.ndarray:
    return _residual_terms(x, g_in, bone_len, bone_w, bi, bj)[2]


def _linearize_tree(
    x: jnp.ndarray,
    g_in: GraphInputs,
    bone_len: jnp.ndarray,
    bone_w: jnp.ndarray,
    bi: jnp.ndarray,
    bj: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Assemble the SAME normal equations as `_linearize` but in
    tree-factored form: diagonal 3x3 blocks + one symmetric coupling block
    per bone (H[bi, bj] = -w u u^T), skipping the dense [P, 63, 63]
    materialization entirely.

    Returns (hdiag [P, K, 3, 3] — undamped, coup [P, B, 3, 3], g [P, K, 3],
    err [P]).
    """
    dtype = x.dtype
    w_r, act, err, u, r_b, wb = _residual_terms(
        x, g_in, bone_len, bone_w, bi, bj
    )
    g = act[..., None] * w_r
    hdiag = g_in.inv_cov  # unmeasured joints keep their unit anchors

    # Signed / unsigned incidence (static): scatter-free contractions.
    inc = _signed_incidence(bi, bj, dtype)
    inc2 = jnp.abs(inc)

    g_b = (wb * r_b)[..., None] * u  # [P, B, 3]
    g = g + linalg.heinsum("bk,pbi->pki", inc, g_b)

    uu = wb[..., None, None] * u[..., :, None] * u[..., None, :]  # [P,B,3,3]
    hdiag = hdiag + linalg.heinsum("bk,pbij->pkij", inc2, uu)
    coup = -uu
    return hdiag, coup, g, err


class PriorResult(NamedTuple):
    x: jnp.ndarray          # [P, K, 3] optimized normalized joints
    marg_cov: jnp.ndarray   # [P, K, 3, 3] marginal covariances (normalized)
    marg_ok: jnp.ndarray    # [P] marginals usable (else default sigma)
    iters: jnp.ndarray      # [P->scalar] LM iterations used (diagnostic)


def optimize(
    g_in: GraphInputs, warm_start: jnp.ndarray, cfg: PriorConfig
) -> PriorResult:
    """Batched LM over all persons (reference :746-767).

    warm_start: [P, K, 3] initial state — previous track estimate where the
    joint persisted, else the measurement (setInitialState semantics).
    Inactive joints must be 0 in both warm_start and meas.
    """
    dtype = g_in.meas.dtype
    p = g_in.meas.shape[0]
    bone_i, bone_j, bone_len_np, bone_sig_np = skeleton.bone_tables(
        cfg.normalize_by_height, cfg.effective_limb_sigma_factor
    )
    bi = jnp.asarray(bone_i)
    bj = jnp.asarray(bone_j)
    bone_len = jnp.asarray(bone_len_np, dtype)
    bone_w = jnp.asarray(1.0 / bone_sig_np**2, dtype)

    x0 = jnp.where(g_in.active[..., None], warm_start, 0.0)
    err0 = _error_only(x0, g_in, bone_len, bone_w, bi, bj)
    lam0 = jnp.full((p,), cfg.lm_initial_lambda, dtype)
    # Persons with no measurements are skipped outright (:739-741).
    done0 = g_in.num_meas == 0

    eye = jnp.eye(3 * _K, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    use_tree = cfg.solver == "tree"

    def _solve_dense(x, lam):
        h, g, _ = _linearize(x, g_in, bone_len, bone_w, bi, bj)
        h2 = h.reshape(p, 3 * _K, 3 * _K)
        g2 = g.reshape(p, 3 * _K)
        damped = h2 + lam[:, None, None] * eye
        # Jacobi equilibration: the root block's information is scaled by
        # root_sigma_factor^2 (1e8 relative to the unit anchors), putting the
        # raw condition number beyond float32; the symmetrically scaled
        # system is well-conditioned in float32.
        sc = 1.0 / jnp.sqrt(
            jnp.maximum(jnp.diagonal(damped, axis1=-2, axis2=-1), 1e-30)
        )
        h_eq = damped * sc[:, :, None] * sc[:, None, :]
        # SPD system: Cholesky is cheaper than LU and never pivots (static
        # schedule).
        delta = sc * _spd_solve(h_eq, (-g2 * sc)[..., None])[..., 0]
        return delta.reshape(p, _K, 3)

    def _solve_tree(x, lam):
        # The bone graph is a forest (skeleton.SPINE_BONE_IDX gating), so
        # the normal equations factor along the tree: ~6 sequential levels
        # of batched 3x3 block ops instead of XLA's 63x63 Cholesky custom
        # call (which costs ~8 us PER MATRIX regardless of batch — the
        # dominant cost of the whole pipeline before this path existed).
        hdiag, coup, g, _ = _linearize_tree(
            x, g_in, bone_len, bone_w, bi, bj
        )
        damped = hdiag + lam[:, None, None, None] * eye3
        delta, _ = tree_solve.tree_solve_levels(
            damped, coup, g_in.bone_active, -g
        )
        return delta

    def lm_step(state):
        x, lam, err, done, it = state
        delta = _solve_tree(x, lam) if use_tree else _solve_dense(x, lam)
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        x_new = x + delta
        err_new = _error_only(x_new, g_in, bone_len, bone_w, bi, bj)
        accept = (err_new < err) & jnp.isfinite(err_new)
        dec = err - err_new
        # Converged when the attempted step barely changes the error —
        # in either direction (gtsam checkConvergence semantics); a state
        # already at the optimum must terminate immediately rather than
        # escalate lambda to the ceiling.
        conv = jnp.isfinite(err_new) & (
            (jnp.abs(dec) <= cfg.lm_absolute_error_tol)
            | (jnp.abs(dec) <= cfg.lm_relative_error_tol * err)
        )
        x = jnp.where((accept & ~done)[:, None, None], x_new, x)
        err = jnp.where(accept & ~done, err_new, err)
        lam_next = jnp.where(
            accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor
        )
        lam = jnp.where(done, lam, lam_next)
        done = done | conv | (lam > cfg.lm_lambda_upper)
        return x, lam, err, done, it + 1

    def cond(state):
        _, _, _, done, it = state
        return (~jnp.all(done)) & (it < cfg.lm_max_iterations)

    x, lam, err, done, iters = jax.lax.while_loop(
        cond, lm_step, (x0, lam0, err0, done0, jnp.int32(0))
    )

    # Optimization-failure fallback (:748-758): any non-finite state falls
    # back to the raw measurements.
    bad = ~jnp.all(jnp.isfinite(x.reshape(p, -1)), axis=-1)
    x = jnp.where(bad[:, None, None], g_in.meas, x)

    # Marginals: diagonal 3x3 blocks of the inverse undamped Hessian
    # (:760-767); non-finite -> default sigma fallback.
    if use_tree:
        # Sparse-inverse recursion along the bone tree yields exactly the
        # diagonal blocks of H^-1 — no 63-RHS dense inverse needed.
        hdiag_f, coup_f, _, _ = _linearize_tree(
            x, g_in, bone_len, bone_w, bi, bj
        )
        _, marg = tree_solve.tree_solve_levels(
            hdiag_f,
            coup_f,
            g_in.bone_active,
            jnp.zeros_like(x),
            want_sigma=True,
        )
        marg_ok = (
            jnp.all(jnp.isfinite(marg.reshape(p, -1)), axis=-1) & ~bad
        )
        marg = jnp.where(
            marg_ok[:, None, None, None],
            marg,
            jnp.broadcast_to(jnp.eye(3, dtype=dtype), marg.shape),
        )
    else:
        h, _, _ = _linearize(x, g_in, bone_len, bone_w, bi, bj)
        h2 = h.reshape(p, 3 * _K, 3 * _K)
        # Equilibrated inverse (see _solve_dense): H^-1 = S (S H S)^-1 S.
        sc = 1.0 / jnp.sqrt(
            jnp.maximum(jnp.diagonal(h2, axis1=-2, axis2=-1), 1e-30)
        )
        h_eq = h2 * sc[:, :, None] * sc[:, None, :]
        inv_eq = _spd_solve(
            h_eq, jnp.broadcast_to(jnp.eye(3 * _K, dtype=dtype), h_eq.shape)
        )
        cov_full = inv_eq * sc[:, :, None] * sc[:, None, :]
        marg_ok = (
            jnp.all(jnp.isfinite(cov_full.reshape(p, -1)), axis=-1) & ~bad
        )
        cov_full = jnp.where(
            marg_ok[:, None, None], cov_full, jnp.eye(3 * _K, dtype=dtype)
        )
        blocks = cov_full.reshape(p, _K, 3, _K, 3)
        k_idx = jnp.arange(_K)
        marg = jnp.swapaxes(blocks[:, k_idx, :, k_idx, :], 0, 1)
    return PriorResult(x=x, marg_cov=marg, marg_ok=marg_ok, iters=iters)


def denormalize(
    result: PriorResult, g_in: GraphInputs, cfg: PriorConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Map optimized joints/covariances back to the base frame (:774-816)."""
    dtype = result.x.dtype
    h = g_in.height[:, None, None]
    xyz = result.x * h + g_in.root_xyz[:, None, :]
    h2 = (g_in.height**2)[:, None, None, None]
    cov = result.marg_cov * h2
    # Fallback sigma where marginals were unusable.
    default = cfg.default_res_sigma**2 * jnp.eye(3, dtype=dtype)
    cov = jnp.where(result.marg_ok[:, None, None, None], cov, default)
    # Root covariance re-inflated by the pinning factor (:813-814).
    rho2 = jnp.asarray(cfg.root_sigma_factor**2, dtype)
    cov = cov.at[:, skeleton.MIDHIP].multiply(rho2)
    return xyz, cov
