"""Tree-structured block elimination for the skeleton prior's normal
equations.

The active bone factors always form a forest over the 21 joints (each child
joint has at most one active parent bone; the COCO spine and the H36M belly
chain are mutually exclusive — skeleton.py:SPINE_BONE_IDX), so the LM Hessian
is block-tridiagonal along the tree: 3x3 diagonal blocks plus one symmetric
3x3 coupling per bone. Solving it by leaf-to-root block elimination +
root-to-leaf back-substitution costs 21 tiny 3x3 steps instead of a dense
63x63 factorization, and the sparse-inverse recursion gives the marginal
covariance blocks (gtsam's Marginals) in one more backward sweep.

Two implementations with identical math: the level-grouped production
solver (`tree_solve_levels`, ~6 batched 3x3 levels) and a bone-sequential
readable variant (`tree_solve`, the oracle in tests). All 3x3 block
contractions are componentwise multiply-adds (`_m3`/`_mv3`), not dots —
true float32 whatever precision the backend's dots default to, without a
multi-pass HIGHEST product on these tiny blocks.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smartedgesensor3dhumanpose_tpu import skeleton

_K = skeleton.NUM_FUSION_JOINTS
_B = skeleton.NUM_BONES


def _elimination_order() -> np.ndarray:
    """Bones ordered children-first (decreasing max child depth)."""
    parents = {}
    for b in range(_B):
        parents.setdefault(int(skeleton.BONE_J[b]), []).append(
            int(skeleton.BONE_I[b])
        )

    def depth(n):
        if n not in parents:
            return 0
        return 1 + max(depth(p) for p in parents[n])

    return np.array(
        sorted(range(_B), key=lambda b: -depth(int(skeleton.BONE_J[b]))),
        dtype=np.int32,
    )


ELIMINATION_ORDER = _elimination_order()


def _levels() -> list[np.ndarray]:
    """Bones grouped by the depth of their child joint, deepest level first.

    All bones in a level have children at the same tree depth and parents one
    level up, so they can be eliminated SIMULTANEOUSLY (batched 3x3 ops with
    a scatter-add for sibling bones sharing a parent). The skeleton tree is
    ~6 levels deep, so the sequential chain shrinks from NUM_BONES steps to
    ~6 — the difference between launch-bound and compute-bound.
    """
    parents = {}
    for b in range(_B):
        parents.setdefault(int(skeleton.BONE_J[b]), []).append(
            int(skeleton.BONE_I[b])
        )

    def node_depth(n):
        if n not in parents:
            return 0
        return 1 + max(node_depth(p) for p in parents[n])

    depth_of_bone = [node_depth(int(skeleton.BONE_J[b])) for b in range(_B)]
    out = []
    for d in sorted(set(depth_of_bone), reverse=True):
        out.append(
            np.array(
                [b for b in range(_B) if depth_of_bone[b] == d],
                dtype=np.int32,
            )
        )
    return out


LEVELS = _levels()



def _m3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3x3 @ 3x3 as componentwise multiply-add (no dot_general):
    true float32 whatever the backend's dot precision, with no multi-pass
    HIGHEST decomposition on these tiny sequential-scan blocks."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _m3t(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3x3 @ 3x3^T, componentwise (see _m3)."""
    return jnp.sum(a[..., :, None, :] * b[..., None, :, :], axis=-1)


def _mv3(a: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched 3x3 @ 3-vector, componentwise (see _m3)."""
    return jnp.sum(a * v[..., None, :], axis=-1)


def tree_solve_levels(
    hdiag: jnp.ndarray,
    bone_coup: jnp.ndarray,
    bone_active: jnp.ndarray,
    rhs: jnp.ndarray,
    want_sigma: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Level-parallel tree_solve (same contract, identical math).

    Within a level every bone's child is unique up to mutually-exclusive
    duplicates (the NECK's two alternative parent bones), so child writes are
    combined with masked scatter-adds; sibling bones accumulate into their
    shared parent through ordinary scatter-add.
    """
    d = hdiag
    r = rhs
    act = bone_active
    k = hdiag.shape[1]

    def coup_at(lvl):
        on = act[:, lvl]  # [P, L]
        return jnp.where(on[..., None, None], bone_coup[:, lvl], 0.0), on

    # Forward: eliminate whole levels, deepest first.
    for lvl in LEVELS:
        p_idx = jnp.asarray(skeleton.BONE_I[lvl])
        c_idx = jnp.asarray(skeleton.BONE_J[lvl])
        c_m, on = coup_at(lvl)  # [P, L, 3, 3]
        dc_inv = _inv3(d[:, c_idx])
        cdinv = _m3(c_m, dc_inv)
        d = d.at[:, p_idx].add(-_m3(cdinv, c_m))
        r = r.at[:, p_idx].add(-_mv3(cdinv, r[:, c_idx]))

    # Backward: roots, then levels from shallow to deep.
    d_inv = _inv3(d)
    x = _mv3(d_inv, r)
    for lvl in LEVELS[::-1]:
        p_idx = jnp.asarray(skeleton.BONE_I[lvl])
        c_idx = jnp.asarray(skeleton.BONE_J[lvl])
        c_m, on = coup_at(lvl)
        xc = _mv3(
            d_inv[:, c_idx],
            r[:, c_idx] - _mv3(c_m, x[:, p_idx]),
        )
        # Duplicate children within a level are mutually exclusive actives:
        # zero the updated slots, scatter-add the masked values, keep old
        # values where no bone fired.
        upd = jnp.zeros_like(x).at[:, c_idx].add(
            jnp.where(on[..., None], xc, 0.0)
        )
        fired = jnp.zeros((x.shape[0], k), bool).at[:, c_idx].max(on)
        x = jnp.where(fired[..., None], upd, x)

    if not want_sigma:
        return x, jnp.broadcast_to(jnp.eye(3, dtype=x.dtype), hdiag.shape)

    sigma = d_inv
    for lvl in LEVELS[::-1]:
        p_idx = jnp.asarray(skeleton.BONE_I[lvl])
        c_idx = jnp.asarray(skeleton.BONE_J[lvl])
        c_m, on = coup_at(lvl)
        k_m = _m3(d_inv[:, c_idx], c_m)
        s_c = d_inv[:, c_idx] + _m3t(_m3(k_m, sigma[:, p_idx]), k_m)
        upd = jnp.zeros_like(sigma).at[:, c_idx].add(
            jnp.where(on[..., None, None], s_c, 0.0)
        )
        fired = jnp.zeros((sigma.shape[0], k), bool).at[:, c_idx].max(on)
        sigma = jnp.where(fired[..., None, None], upd, sigma)
    return x, sigma


def _inv3(m: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse (adjugate / det) with a guard."""
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
    safe = jnp.abs(det) > 1e-30
    return adj / jnp.where(safe, det, 1.0)[..., None, None]


def tree_solve(
    hdiag: jnp.ndarray,
    bone_coup: jnp.ndarray,
    bone_active: jnp.ndarray,
    rhs: jnp.ndarray,
    want_sigma: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Solve H x = rhs for the tree-structured skeleton Hessian (plain JAX).

    Args:
      hdiag: [P, K, 3, 3] diagonal blocks (damping already added).
      bone_coup: [P, B, 3, 3] symmetric coupling blocks C_b (the matrix at
        H[parent_b, child_b]; usually -w_b u_b u_b^T).
      bone_active: [P, B] bool.
      rhs: [P, K, 3].
      want_sigma: also return the diagonal blocks of H^{-1}.

    Returns:
      (x [P, K, 3], sigma [P, K, 3, 3] — identity-shaped garbage when
      want_sigma=False).
    """
    d = hdiag
    r = rhs
    act = bone_active

    # Forward: eliminate children into parents.
    for b in ELIMINATION_ORDER.tolist():
        p_idx, c_idx = int(skeleton.BONE_I[b]), int(skeleton.BONE_J[b])
        on = act[:, b]
        c_m = jnp.where(on[:, None, None], bone_coup[:, b], 0.0)
        dc_inv = _inv3(d[:, c_idx])
        cdinv = _m3(c_m, dc_inv)  # [P, 3, 3]
        d = d.at[:, p_idx].add(-_m3(cdinv, c_m))
        r = r.at[:, p_idx].add(-_mv3(cdinv, r[:, c_idx]))

    # Backward: roots directly, then children in reverse order.
    d_inv = _inv3(d)  # [P, K, 3, 3] (children's blocks are as-at-elimination)
    x = _mv3(d_inv, r)
    for b in ELIMINATION_ORDER.tolist()[::-1]:
        p_idx, c_idx = int(skeleton.BONE_I[b]), int(skeleton.BONE_J[b])
        on = act[:, b]
        c_m = jnp.where(on[:, None, None], bone_coup[:, b], 0.0)
        xc = _mv3(
            d_inv[:, c_idx],
            r[:, c_idx] - _mv3(c_m, x[:, p_idx]),
        )
        x = x.at[:, c_idx].set(jnp.where(on[:, None], xc, x[:, c_idx]))

    if not want_sigma:
        return x, jnp.broadcast_to(jnp.eye(3, dtype=x.dtype), hdiag.shape)

    # Sparse-inverse recursion for the marginal diagonal blocks.
    sigma = d_inv
    for b in ELIMINATION_ORDER.tolist()[::-1]:
        p_idx, c_idx = int(skeleton.BONE_I[b]), int(skeleton.BONE_J[b])
        on = act[:, b]
        c_m = jnp.where(on[:, None, None], bone_coup[:, b], 0.0)
        k_m = _m3(d_inv[:, c_idx], c_m)
        s_c = d_inv[:, c_idx] + _m3t(_m3(k_m, sigma[:, p_idx]), k_m)
        sigma = sigma.at[:, c_idx].set(
            jnp.where(on[:, None, None], s_c, sigma[:, c_idx])
        )
    return x, sigma

