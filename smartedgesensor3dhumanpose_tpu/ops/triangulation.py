"""Masked, batched confidence-weighted DLT triangulation.

Batched-array rework of the reference's per-joint scalar triangulation
(skeleton_3d_triang_mult_node.cpp:425-465, OpenPose-3D lineage :740-743).
The reference assembles a 2k x 4 design matrix A per joint and takes the
smallest right singular vector via JacobiSVD; here we form the 4x4 normal
matrix A^T A with masked rows — so the view count is a mask, not a shape —
and extract its smallest eigenvector with a batched Jacobi eigensolver.
Every batch dimension (people x joints x sigma-points x leave-one-out
variants) folds into one big elementwise program.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from smartedgesensor3dhumanpose_tpu.ops import linalg


def dlt_rows(
    P: jnp.ndarray,
    kp: jnp.ndarray,
    view_mask: jnp.ndarray,
    weight_by_conf: bool,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Build the two DLT rows per view: normalized, confidence-weighted.

    r1 = x * P[2] - P[0], r2 = y * P[2] - P[1], each row L2-normalized and
    optionally scaled by the keypoint confidence (reference :443-454). Rows of
    masked-out views are zeroed.

    Args:
      P: [C, 3, 4] camera extrinsics.
      kp: [..., C, 3] normalized keypoints (x, y, conf).
      view_mask: [..., C] bool.
      weight_by_conf: scale rows by confidence.

    Returns:
      (r1, r2): each [..., C, 4].
    """
    x = kp[..., 0:1]
    y = kp[..., 1:2]
    conf = kp[..., 2:3]
    r1 = x * P[..., 2, :] - P[..., 0, :]
    r2 = y * P[..., 2, :] - P[..., 1, :]

    def norm_rows(r):
        n = jnp.linalg.norm(r, axis=-1, keepdims=True)
        r = r / jnp.where(n > 0, n, 1.0)
        if weight_by_conf:
            r = r * conf
        return jnp.where(view_mask[..., None], r, 0.0)

    return norm_rows(r1), norm_rows(r2)


def _normal_matrix_direct(P, kp, view_mask, weight_by_conf):
    """A^T A via materialized DLT rows (works for batch-dependent P)."""
    r1, r2 = dlt_rows(P, kp, view_mask, weight_by_conf)
    return linalg.heinsum("...ci,...cj->...ij", r1, r1) + linalg.heinsum(
        "...ci,...cj->...ij", r2, r2
    )


def coeff_constants(P, dtype):
    """The five constant per-camera 4x4 outer products of the coefficient
    form: [C, 5, 4, 4] (constant-folded by XLA when P is static data)."""
    p0, p1, p2 = P[:, 0], P[:, 1], P[:, 2]  # [C, 4]

    def outer(a, b):
        return a[:, :, None] * b[:, None, :]

    a22 = outer(p2, p2)
    a02 = outer(p0, p2)
    a12 = outer(p1, p2)
    return jnp.stack(
        [
            a22,
            a02 + jnp.swapaxes(a02, -1, -2),
            outer(p0, p0),
            a12 + jnp.swapaxes(a12, -1, -2),
            outer(p1, p1),
        ],
        axis=1,
    ).astype(dtype)


def view_coeffs(P, kp, view_mask, weight_by_conf):
    """Per-view scalar coefficients of the normal-matrix coefficient form.

    Each normalized, weighted DLT row pair contributes
      w^2 (x p2 - p0)(x p2 - p0)^T / ||x p2 - p0||^2  (+ the y row)
    which expands over the five constant outer products of
    `coeff_constants` with scalar coefficients in x, y, conf. Masked views
    contribute zero. Returns [..., C, 5].
    """
    P = jnp.asarray(P)
    p0, p1, p2 = P[:, 0], P[:, 1], P[:, 2]
    n22 = jnp.sum(p2 * p2, -1)
    n00 = jnp.sum(p0 * p0, -1)
    n11 = jnp.sum(p1 * p1, -1)
    n02 = jnp.sum(p0 * p2, -1)
    n12 = jnp.sum(p1 * p2, -1)

    x = kp[..., 0]
    y = kp[..., 1]
    w2 = kp[..., 2] ** 2 if weight_by_conf else jnp.ones_like(x)
    nx = x * x * n22 - 2.0 * x * n02 + n00
    ny = y * y * n22 - 2.0 * y * n12 + n11
    wmask = jnp.where(view_mask, w2, 0.0)
    inv_nx = wmask / jnp.maximum(nx, 1e-30)
    inv_ny = wmask / jnp.maximum(ny, 1e-30)
    return jnp.stack(
        [
            x * x * inv_nx + y * y * inv_ny,
            -x * inv_nx,
            inv_nx,
            -y * inv_ny,
            inv_ny,
        ],
        axis=-1,
    )  # [..., C, 5]


def view_contribs(P, kp, view_mask, weight_by_conf):
    """Per-view 4x4 normal-matrix contributions T_c with A^T A = sum_c T_c.

    The incremental building block for the leave-one-out and sigma-point
    batches: dropping view c is `A^T A - T_c`, and perturbing view c's
    keypoint replaces only T_c — so the O(batch x samples x C) coefficient
    tensors of a from-scratch rebuild never materialize (the HBM-bandwidth
    hot path of the scaled config). Returns [..., C, 4, 4].
    """
    coeff = view_coeffs(P, kp, view_mask, weight_by_conf)
    const = coeff_constants(P, kp.dtype)
    return linalg.heinsum("...ck,ckij->...cij", coeff, const)


def _normal_matrix_coeff(P, kp, view_mask, weight_by_conf):
    """A^T A in closed coefficient form (static P only): the [..., C, 5]
    coefficient tensor contracted against the [C, 5, 4, 4] constants on the
    MXU — the big [..., C, 4] row tensors never materialize."""
    coeff = view_coeffs(P, kp, view_mask, weight_by_conf)
    const = coeff_constants(P, kp.dtype)
    return linalg.heinsum("...ck,ckij->...ij", coeff, const)


def triangulate(
    P: jnp.ndarray,
    kp: jnp.ndarray,
    view_mask: jnp.ndarray,
    weight_by_conf: bool = True,
    sweeps: int = 8,
) -> jnp.ndarray:
    """Triangulate one 3D point per batch element from masked views.

    Minimizes ||A x||, ||x|| = 1 over the homogeneous point x: the smallest
    eigenvector of A^T A (equivalent to the reference's smallest-singular-
    vector solution :456), then de-homogenizes.

    Args:
      P: [C, 3, 4] camera extrinsics.
      kp: [..., C, 3] normalized keypoints (x, y, conf).
      view_mask: [..., C] bool; fewer than 2 valid views yields an
        unspecified (finite) point — callers gate on the view count.

    Returns:
      [..., 3] triangulated points.
    """
    if P.ndim == 3:
        m = _normal_matrix_coeff(P, kp, view_mask, weight_by_conf)
    else:
        m = _normal_matrix_direct(P, kp, view_mask, weight_by_conf)
    return solve_normal(m, jnp.sum(view_mask, axis=-1))


def solve_normal(m: jnp.ndarray, n_views: jnp.ndarray) -> jnp.ndarray:
    """Solve min ||A x||, ||x|| = 1 from the 4x4 normal matrix m = A^T A.

    The incremental entry point: callers assemble m themselves (e.g. as
    `sum(view_contribs) - T_c` for leave-one-out, or base + delta for sigma
    points) and hand it here with the matching valid-view count.

    Args:
      m: [..., 4, 4] normal matrices.
      n_views: [...] valid view count; lanes with fewer than 2 views yield 0
        (masked-out batches have m == 0 — bias with identity so the
        eigensolver stays finite; callers gate those lanes out).
    """
    deficient = n_views < 2
    m = m + jnp.where(deficient[..., None, None], 1.0, 0.0) * jnp.eye(
        4, dtype=m.dtype
    )
    h = linalg.smallest_eigvec4_psd(m)
    w = h[..., 3]
    w = jnp.where(jnp.abs(w) > 1e-20, w, 1e-20)
    xyz = h[..., :3] / w[..., None]
    # Deficient lanes are gated out by callers; keep them finite and tame.
    return jnp.where(deficient[..., None], 0.0, xyz)


def reprojection_error(
    xyz: jnp.ndarray,
    P: jnp.ndarray,
    kp: jnp.ndarray,
    view_mask: jnp.ndarray,
) -> jnp.ndarray:
    """Confidence-weighted mean reprojection error in normalized coords.

    err = sum_i conf_i * ||proj_i(x) - kp_i|| / sum_i conf_i over valid views
    (reference calcReprojectionError, :425-438).

    Args:
      xyz: [..., 3] points.
      P: [C, 3, 4].
      kp: [..., C, 3] (x, y, conf).
      view_mask: [..., C] bool.

    Returns:
      [...] error.
    """
    # Componentwise projection (4-term multiply-adds, not a dot): the LOO
    # batch of the scaled config projects [H, J, C, C] points — as a dot
    # that materializes tens of MB; elementwise it fuses into the error
    # reduction.
    x = xyz[..., None, 0:1]  # [..., 1, 1] broadcast over C
    y = xyz[..., None, 1:2]
    zc = xyz[..., None, 2:3]

    def row(i):
        return (
            P[:, i, 0] * x[..., 0]
            + P[:, i, 1] * y[..., 0]
            + P[:, i, 2] * zc[..., 0]
            + P[:, i, 3]
        )  # [..., C]

    z = row(2)
    z = jnp.where(jnp.abs(z) > 1e-20, z, 1e-20)
    ex = row(0) / z - kp[..., 0]
    ey = row(1) / z - kp[..., 1]
    err = jnp.sqrt(ex * ex + ey * ey)
    conf = jnp.where(view_mask, kp[..., 2], 0.0)
    norm = jnp.sum(conf, axis=-1)
    total = jnp.sum(conf * jnp.where(view_mask, err, 0.0), axis=-1)
    return total / jnp.where(norm > 0, norm, 1.0)


def triangulate_with_error(
    P: jnp.ndarray,
    kp: jnp.ndarray,
    view_mask: jnp.ndarray,
    weight_by_conf: bool = True,
    sweeps: int = 8,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Triangulate and compute the weighted reprojection error in one call."""
    xyz = triangulate(P, kp, view_mask, weight_by_conf, sweeps)
    return xyz, reprojection_error(xyz, P, kp, view_mask)
