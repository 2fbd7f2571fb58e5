"""Jittable rectangular linear-sum assignment (Jonker-Volgenant).

The reference links a C++ Munkres implementation and calls it from both the
cross-view association (skeleton_3d_triang_mult_node.cpp:630) and the track
association (pose_prior_mult_node.cpp:561). Those matrices are tiny (tens of
rows/columns at most), so rather than a host callback we run a dense
shortest-augmenting-path Jonker-Volgenant solver entirely on device inside
`lax.scan`/`lax.while_loop` — it stays inside the jitted per-frame program.

This is an original implementation of the textbook JV algorithm with dual
potentials. Rectangular problems are padded to square with zero-cost dummy
rows/columns, which preserves Munkres' rectangular semantics (the smaller side
is fully assigned, minimizing total cost over the real block).

Precision note: the solver works in the input dtype. In float32, mixing very
large "infeasible" placeholder costs (e.g. 1e6) with small real costs loses
precision in the reduced costs; callers should clip placeholder costs to a
moderate ceiling (~1e3) — the optimum over feasible entries is unaffected as
long as all placeholder entries share one value that dominates real costs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_INF = 1.0e18


def _solve_square(cost: jnp.ndarray) -> jnp.ndarray:
    """Optimal assignment for a square [N, N] cost matrix.

    Returns row_of_col: [N + 1] int32 (virtual column N used internally).
    """
    n = cost.shape[0]
    dtype = cost.dtype
    inf = jnp.asarray(_INF, dtype)

    u0 = jnp.zeros((n,), dtype)  # row potentials
    v0 = jnp.zeros((n + 1,), dtype)  # column potentials (+ virtual column)
    roc0 = jnp.full((n + 1,), -1, jnp.int32)  # row matched to each column

    def assign_row(carry, r):
        u, v, roc = carry
        roc = roc.at[n].set(r)  # the virtual column holds the row to place

        minv0 = jnp.full((n,), inf, dtype)
        way0 = jnp.full((n,), n, jnp.int32)  # predecessor column on the tree
        used0 = jnp.zeros((n + 1,), bool)

        def cond_fun(state):
            _u, _v, _minv, _way, _used, j0 = state
            return roc[j0] >= 0

        def body_fun(state):
            u, v, minv, way, used, j0 = state
            used = used.at[j0].set(True)
            i0 = roc[j0]
            # Relax all unused columns through row i0.
            cur = cost[i0, :] - u[i0] - v[:n]
            better = (cur < minv) & ~used[:n]
            minv = jnp.where(better, cur, minv)
            way = jnp.where(better, j0, way)
            masked = jnp.where(used[:n], inf, minv)
            j1 = jnp.argmin(masked).astype(jnp.int32)
            delta = masked[j1]
            # Dual update: tree columns (and their matched rows) shift by
            # delta, the rest tighten their best reduced cost.
            rows_on_tree = jnp.where(used, roc, 0)
            u = u.at[rows_on_tree].add(jnp.where(used, delta, 0.0))
            v = jnp.where(used, v - delta, v)
            minv = jnp.where(used[:n], minv, minv - delta)
            return u, v, minv, way, used, j1

        u, v, _minv, way, _used, j0 = jax.lax.while_loop(
            cond_fun, body_fun, (u, v, minv0, way0, used0, jnp.int32(n))
        )

        # Augment along the predecessor chain back to the virtual column.
        def aug_cond(state):
            _roc, j = state
            return j != n

        def aug_body(state):
            roc, j = state
            jprev = way[j]
            roc = roc.at[j].set(roc[jprev])
            return roc, jprev

        roc, _ = jax.lax.while_loop(aug_cond, aug_body, (roc, j0))
        return (u, v, roc), None

    (_, _, roc), _ = jax.lax.scan(
        assign_row, (u0, v0, roc0), jnp.arange(n, dtype=jnp.int32)
    )
    return roc


def _solve_square_unrolled(cost: jnp.ndarray) -> jnp.ndarray:
    """Fully-unrolled JV for small N: no `while_loop`s, so the whole solve
    fuses into a handful of kernels instead of hundreds of sequential
    loop-iteration dispatches, each of which costs a fixed launch and
    predicate round trip regardless of width.

    Identical algorithm to `_solve_square`; every data-dependent loop is
    replaced by a static-trip-count loop with masked updates (an augmenting
    search marks one column per active step, so N+1 steps always suffice).
    """
    n = cost.shape[0]
    dtype = cost.dtype
    inf = jnp.asarray(_INF, dtype)
    cols = jnp.arange(n, dtype=jnp.int32)

    u0 = jnp.zeros((n,), dtype)
    v0 = jnp.zeros((n + 1,), dtype)
    roc0 = jnp.full((n + 1,), -1, jnp.int32)

    def assign_row(carry, r):
        u, v, roc = carry
        roc = roc.at[n].set(r)
        minv = jnp.full((n,), inf, dtype)
        way = jnp.full((n,), n, jnp.int32)
        used = jnp.zeros((n + 1,), bool)
        # Rows on the alternating tree (their potentials shift by delta);
        # tracked incrementally to avoid a gather/scatter per step.
        row_on_tree = jnp.zeros((n,), bool)
        j0 = jnp.int32(n)
        for _ in range(n + 1):
            active = roc[j0] >= 0
            i0 = roc[j0]
            used_new = used.at[j0].set(True)
            row_on_tree_new = row_on_tree.at[i0].set(True)
            cur = cost[i0, :] - u[i0] - v[:n]
            better = (cur < minv) & ~used_new[:n] & active
            minv = jnp.where(better, cur, minv)
            way = jnp.where(better, j0, way)
            masked = jnp.where(used_new[:n], inf, minv)
            j1 = jnp.argmin(masked).astype(jnp.int32)
            delta = masked[j1]
            u = jnp.where(active & row_on_tree_new, u + delta, u)
            v = jnp.where(active & used_new, v - delta, v)
            minv = jnp.where(active & ~used_new[:n], minv - delta, minv)
            used = jnp.where(active, used_new, used)
            row_on_tree = jnp.where(active, row_on_tree_new, row_on_tree)
            j0 = jnp.where(active, j1, j0)
        # Augment along the predecessor chain (path length <= n + 1).
        for _ in range(n + 1):
            active = j0 != n
            jprev = way[jnp.minimum(j0, n - 1)]
            roc_new = roc.at[j0].set(roc[jprev])
            roc = jnp.where(active, roc_new, roc)
            j0 = jnp.where(active, jprev, j0)
        return (u, v, roc), None

    # Rows run in a scan (the body — one fully-unrolled augmenting search —
    # compiles once); the inner unroll removes the per-iteration loop
    # dispatch, and a modest row unroll amortizes the device-loop overhead
    # without the compile blowup of a full unroll.
    (_, _, roc), _ = jax.lax.scan(
        assign_row,
        (u0, v0, roc0),
        jnp.arange(n, dtype=jnp.int32),
        unroll=min(4, n),
    )
    return roc


# Below this size the unrolled form is used (fused kernels, ~50x fewer
# sequential dispatches); above it the loop form keeps compile times sane.
_UNROLL_LIMIT = 24


def linear_sum_assignment(
    cost: jnp.ndarray,
    unroll: bool = True,
) -> jnp.ndarray:
    """Minimum-cost assignment of a rectangular [R, C] cost matrix.

    Matches the semantics of the reference's `assignmentoptimal`
    (Hungarian.h:24): with R <= C every row is assigned a distinct column;
    with R > C only C rows get columns and the rest return -1. Minimizes the
    summed cost of the assigned pairs.

    Args:
      unroll: for the XLA path, use the unrolled inner search (fastest when
        the solve runs unconditionally). Pass False when the call sits behind
        a rarely-taken `lax.cond`: XLA speculates loop-free branches into
        always-executed selects, so a branch-protected call must keep a
        while_loop inside to stay a true branch.

    Returns:
      col_of_row: [R] int32 column per row, -1 for unassigned rows.
    """
    r, c = cost.shape
    if cost.dtype == jnp.float16:
        cost = cost.astype(jnp.float32)
    n = max(r, c)
    padded = jnp.zeros((n, n), cost.dtype).at[:r, :c].set(cost)
    if unroll and n <= _UNROLL_LIMIT:
        roc = _solve_square_unrolled(padded)
    else:
        roc = _solve_square(padded)
    col_of_row = jnp.full((n,), -1, jnp.int32)
    col_of_row = col_of_row.at[roc[:n]].set(jnp.arange(n, dtype=jnp.int32))
    col_of_row = col_of_row[:r]
    return jnp.where(col_of_row < c, col_of_row, -1)
