"""Batched small-matrix linear algebra primitives.

The reference leans on Eigen for per-joint 4x4/2x2/3x3 factorizations inside
scalar loops (JacobiSVD at skeleton_3d_triang_mult_node.cpp:456, 2x2 Cholesky
at :471-487, 3x3 LLT at skeleton_reproj_mult_node.cpp:72). Here these
become fully-batched elementwise programs: a cyclic Jacobi
eigensolver for symmetric 4x4 systems (replacing the thin SVD of the DLT
design matrix via the normal equations) and closed-form Cholesky factors.
All kernels are shape-polymorphic over leading batch dimensions.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

# Accelerator matmuls may default to reduced-precision passes (TF32 on an
# NVIDIA GPU); the geometry kernels contract tiny dimensions where that
# costs millimeters (measured: ~4.5 mm noise-free
# triangulation error at default precision vs ~1 um at HIGHEST, with no
# meaningful speed difference at these sizes). All framework einsums on the
# geometry path go through this wrapper.
heinsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

# Cyclic order of the six off-diagonal (p, q) pivots of a 4x4 Jacobi sweep.
_JACOBI_PAIRS_4 = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _jacobi_rotation(app, aqq, apq, eps):
    """Jacobi rotation (c, s) annihilating the (p, q) off-diagonal entry.

    Uses the numerically stable t = sign(tau) / (|tau| + sqrt(1 + tau^2))
    formulation; degenerates to the identity when |apq| <= eps.
    """
    small = jnp.abs(apq) <= eps
    safe_apq = jnp.where(small, 1.0, apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(tau == 0.0, 1.0, t)  # tau == 0 -> 45-degree rotation
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    c = jnp.where(small, 1.0, c)
    s = jnp.where(small, 0.0, s)
    return c, s


def eigh4(a: jnp.ndarray, sweeps: int = 8) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Eigendecomposition of batched symmetric 4x4 matrices by cyclic Jacobi.

    A fixed number of unrolled sweeps (quadratic convergence: 6-8 sweeps reach
    machine precision for 4x4) keeps the program static and branch-free —
    ideal for XLA. All updates are elementwise over the batch.

    Args:
      a: [..., 4, 4] symmetric matrices.
      sweeps: number of full cyclic sweeps.

    Returns:
      (w [..., 4] eigenvalues (unsorted), v [..., 4, 4] eigenvectors in
      columns: a @ v[..., :, k] = w[..., k] * v[..., :, k]).
    """
    dtype = a.dtype
    eps = jnp.asarray(1e-36 if dtype == jnp.float64 else 1e-18, dtype)
    batch = a.shape[:-2]
    v = jnp.broadcast_to(jnp.eye(4, dtype=dtype), batch + (4, 4))
    for _ in range(sweeps):
        for p, q in _JACOBI_PAIRS_4:
            c, s = _jacobi_rotation(a[..., p, p], a[..., q, q], a[..., p, q], eps)
            c_ = c[..., None]
            s_ = s[..., None]
            # A <- G^T A G applied as row then column updates (G rotates
            # the (p, q) plane). Row update:
            row_p = c_ * a[..., p, :] - s_ * a[..., q, :]
            row_q = s_ * a[..., p, :] + c_ * a[..., q, :]
            a = a.at[..., p, :].set(row_p).at[..., q, :].set(row_q)
            # Column update:
            col_p = c_ * a[..., :, p] - s_ * a[..., :, q]
            col_q = s_ * a[..., :, p] + c_ * a[..., :, q]
            a = a.at[..., :, p].set(col_p).at[..., :, q].set(col_q)
            # Accumulate eigenvectors: V <- V G.
            v_p = c_ * v[..., :, p] - s_ * v[..., :, q]
            v_q = s_ * v[..., :, p] + c_ * v[..., :, q]
            v = v.at[..., :, p].set(v_p).at[..., :, q].set(v_q)
    w = jnp.diagonal(a, axis1=-2, axis2=-1)
    return w, v


def smallest_eigvec4(a: jnp.ndarray, sweeps: int = 8) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of symmetric 4x4 batches."""
    w, v = eigh4(a, sweeps=sweeps)
    idx = jnp.argmin(w, axis=-1)
    vec = jnp.take_along_axis(v, idx[..., None, None], axis=-1)[..., 0]
    return vec


def adjugate4(a: jnp.ndarray) -> jnp.ndarray:
    """Adjugate (transposed cofactor matrix) of batched 4x4 matrices —
    closed-form, fully elementwise: adj(A) A = det(A) I."""
    m = a

    def det3(r0, r1, r2, c0, c1, c2):
        return (
            m[..., r0, c0]
            * (m[..., r1, c1] * m[..., r2, c2] - m[..., r1, c2] * m[..., r2, c1])
            - m[..., r0, c1]
            * (m[..., r1, c0] * m[..., r2, c2] - m[..., r1, c2] * m[..., r2, c0])
            + m[..., r0, c2]
            * (m[..., r1, c0] * m[..., r2, c1] - m[..., r1, c1] * m[..., r2, c0])
        )

    rows = (0, 1, 2, 3)
    adj_cols = []
    for i in range(4):
        ri = tuple(r for r in rows if r != i)
        col = []
        for j in range(4):
            cj = tuple(c for c in rows if c != j)
            cof = det3(ri[0], ri[1], ri[2], cj[0], cj[1], cj[2])
            col.append(((-1.0) ** (i + j)) * cof)
        adj_cols.append(jnp.stack(col, axis=-1))  # row j of adj = cofactor_ji
    # adj[j, i] = (-1)^{i+j} M_ij  -> we built adj columns indexed by i.
    return jnp.stack(adj_cols, axis=-1)


def smallest_eigvec4_psd(a: jnp.ndarray, iters: int = 3) -> jnp.ndarray:
    """Near-nullspace eigenvector of symmetric PSD 4x4 batches via adjugate
    power iteration — loop-free, built for the DLT normal matrix.

    adj(A) = det(A) A^{-1}; for A with one near-zero eigenvalue every column
    of adj(A) is (up to scale) the corresponding eigenvector, and each
    further application of adj(A) sharpens it by the eigengap ratio. Two
    applications give machine-precision nullvectors for any realistically
    conditioned triangulation (the eigengap of A^T A is the squared
    signal-to-noise ratio). ~10x fewer kernels than the Jacobi sweep
    path; falls back to e4 for rank-deficient (masked) lanes.
    """
    adj = adjugate4(a)
    # Start from the dominant column of adj(A) (all columns align with the
    # nullvector when the smallest eigenvalue separates). The column pick
    # and the matvecs are written as one-hot selects / unrolled
    # multiply-adds, NOT gathers/dots: everything from the caller's normal-
    # matrix assembly through here then fuses into one elementwise program
    # (the sigma-point batches of the scaled config are HBM-bound, and each
    # dot or gather in this chain is a fusion barrier that materializes a
    # [batch, 4, 4] tensor).
    norms = jnp.sum(adj * adj, axis=-2)
    idx = jnp.argmax(norms, axis=-1)
    v = sum(
        jnp.where((idx == k)[..., None], adj[..., :, k], 0.0)
        for k in range(4)
    )
    for _ in range(iters - 1):
        v = sum(adj[..., :, k] * v[..., k:k + 1] for k in range(4))
        n = jnp.linalg.norm(v, axis=-1, keepdims=True)
        v = v / jnp.where(n > 0, n, 1.0)
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    ok = n[..., 0] > 1e-30
    e4 = jnp.zeros_like(v).at[..., 3].set(1.0)
    return jnp.where(ok[..., None], v / jnp.where(n > 0, n, 1.0), e4)


def chol2x2_packed(cov: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Cholesky factor of packed 2x2 covariances (xx, xy, yy).

    Returns packed lower-triangular entries (l11, l21, l22) such that
    L L^T = cov (reference mod_samples, :471-479). Zero / non-PSD inputs yield
    zeros instead of NaNs so masked-out lanes stay finite.
    """
    xx = cov[..., 0]
    xy = cov[..., 1]
    yy = cov[..., 2]
    l11 = jnp.sqrt(jnp.maximum(xx, eps))
    safe = l11 > 0
    l21 = jnp.where(safe, xy / jnp.where(safe, l11, 1.0), 0.0)
    l22 = jnp.sqrt(jnp.maximum(yy - l21 * l21, 0.0))
    return jnp.stack([l11, l21, l22], axis=-1)


def chol3x3(a: jnp.ndarray) -> jnp.ndarray:
    """Closed-form lower Cholesky of batched symmetric PSD 3x3 matrices.

    Guards keep masked (zero) lanes finite; genuine non-PSD inputs are clamped
    at zero pivots (matching Eigen LLT's behavior closely enough for the
    sigma-point draws it feeds, skeleton_reproj_mult_node.cpp:72).
    """
    def safe_div(num, den):
        ok = den > 0
        return jnp.where(ok, num / jnp.where(ok, den, 1.0), 0.0)

    l11 = jnp.sqrt(jnp.maximum(a[..., 0, 0], 0.0))
    l21 = safe_div(a[..., 1, 0], l11)
    l31 = safe_div(a[..., 2, 0], l11)
    l22 = jnp.sqrt(jnp.maximum(a[..., 1, 1] - l21 * l21, 0.0))
    l32 = safe_div(a[..., 2, 1] - l31 * l21, l22)
    l33 = jnp.sqrt(jnp.maximum(a[..., 2, 2] - l31 * l31 - l32 * l32, 0.0))
    zero = jnp.zeros_like(l11)
    row0 = jnp.stack([l11, zero, zero], axis=-1)
    row1 = jnp.stack([l21, l22, zero], axis=-1)
    row2 = jnp.stack([l31, l32, l33], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def sym3_pack(a: jnp.ndarray) -> jnp.ndarray:
    """3x3 symmetric matrix -> packed (xx, xy, xz, yy, yz, zz) — the
    KeypointWithCovariance.msg wire layout."""
    return jnp.stack(
        [a[..., 0, 0], a[..., 0, 1], a[..., 0, 2],
         a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]],
        axis=-1,
    )


def sym3_unpack(p: jnp.ndarray) -> jnp.ndarray:
    """Packed (xx, xy, xz, yy, yz, zz) -> full symmetric 3x3."""
    row0 = jnp.stack([p[..., 0], p[..., 1], p[..., 2]], axis=-1)
    row1 = jnp.stack([p[..., 1], p[..., 3], p[..., 4]], axis=-1)
    row2 = jnp.stack([p[..., 2], p[..., 4], p[..., 5]], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)
