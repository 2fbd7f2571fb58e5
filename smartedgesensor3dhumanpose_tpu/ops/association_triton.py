"""Pallas-Triton kernel: the whole greedy cross-view association of a frame.

The association (reference skeleton_3d_triang_mult_node.cpp:562-674, rebuilt
as a fixed-shape fold in fusion.associate) is a C-step sequential fold: each
camera's detections are matched against the hypothesis set accumulated from
the previous cameras, with a Jonker-Volgenant solve on ambiguous steps. As
an XLA program that fold is a chain of C dependent steps, each a `lax.cond`
around a `while_loop` JV whose every iteration is decided by a predicate the
GPU hands back to the host.

Here one program (thread block) folds one frame: grid = (frames,), the camera
axis is a loop inside the kernel, and the hypothesis state (`det_slot`
[S, Cp], the live and dropped counts) is loop-carried in registers. Per
camera the kernel

* gathers, for every hypothesis, the cost rows of its observations in the
  earlier cameras from the frame's sentinel cost table (one [S, S] gather per
  earlier camera: no one-hot product over the whole [C*D, D] slice),
* derives cost, veto and feasibility exactly like fusion._associate_camera,
* runs the square JV (ops.hungarian._solve_square, with the same row order,
  potentials and first-index tie-break) only when some row or column has
  more than one feasible pairing (the reference's :628 gate),
* spawns and extends hypotheses in the reference's order (:636-673).

All [hypothesis, detection] tiles are S x S with S the smallest power of two
above the JV's square size max(H, D) (Triton wants power-of-two blocks);
padding rows and columns are vetoed, so the integer results are bit-equal to
the XLA fold. Every reduction is exact (integer counts, or float sums taken
in camera order); the kernel contains no dot.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from smartedgesensor3dhumanpose_tpu.ops import hungarian

_I32 = jnp.int32


def _pick(vec, idx, lanes):
    """vec[idx] for a [S] vector and a scalar index (masked reduce)."""
    return jnp.sum(jnp.where(lanes == idx, vec, 0), dtype=vec.dtype)


def _any(mask, axis):
    """jnp.any as an integer max (Triton has no boolean reductions)."""
    return jnp.max(mask.astype(_I32), axis=axis) > 0


def _first_min(vec, lanes, size):
    """(min(vec), first index attaining it) — jnp.argmin's tie-break."""
    m = jnp.min(vec)
    return m, jnp.min(jnp.where(vec == m, lanes, size)).astype(_I32)


def _jv(sq, n: int, s: int):
    """Jonker-Volgenant on the leading [n, n] block of the [S, S] `sq`.

    The same shortest-augmenting-path iteration as
    ops.hungarian._solve_square (row potentials u, column potentials v with
    the virtual column n, `roc` = row matched to each column), on padded
    vectors. Returns the column of each row (rows >= n: -1)."""
    dtype = sq.dtype
    inf = jnp.asarray(hungarian._INF, dtype)
    lanes = jnp.arange(s, dtype=_I32)
    real = lanes < n
    rows2 = jax.lax.broadcasted_iota(_I32, (s, s), 0)

    def assign_row(r, carry):
        u, v, roc = carry
        roc = jnp.where(lanes == n, r, roc)  # the virtual column holds row r

        def search_cond(st):
            return st[-1] >= 0

        def search_body(st):
            u, v, minv, way, used, on_tree, j0, i0 = st
            used = used | (lanes == j0)
            on_tree = on_tree | (lanes == i0)
            row = jnp.sum(jnp.where(rows2 == i0, sq, 0), axis=0, dtype=dtype)
            cur = row - _pick(u, i0, lanes) - v
            better = (cur < minv) & ~used & real
            minv = jnp.where(better, cur, minv)
            way = jnp.where(better, j0, way)
            masked = jnp.where(used | ~real, inf, minv)
            delta, j1 = _first_min(masked, lanes, s)
            u = jnp.where(on_tree, u + delta, u)
            v = jnp.where(used, v - delta, v)
            minv = jnp.where(used, minv, minv - delta)
            return u, v, minv, way, used, on_tree, j1, _pick(roc, j1, lanes)

        u, v, _, way, _, _, j0, _ = jax.lax.while_loop(
            search_cond,
            search_body,
            (
                u,
                v,
                jnp.full((s,), inf, dtype),
                jnp.full((s,), n, _I32),
                jnp.zeros((s,), bool),
                jnp.zeros((s,), bool),
                jnp.asarray(n, _I32),
                jnp.asarray(r, _I32),
            ),
        )

        # Augment along the predecessor chain back to the virtual column.
        def aug_body(st):
            roc, j = st
            jprev = _pick(way, j, lanes)
            roc = jnp.where(lanes == j, _pick(roc, jprev, lanes), roc)
            return roc, jprev

        roc, _ = jax.lax.while_loop(
            lambda st: st[1] != n, aug_body, (roc, j0)
        )
        return u, v, roc

    _, _, roc = jax.lax.fori_loop(
        0,
        n,
        assign_row,
        (
            jnp.zeros((s,), dtype),
            jnp.zeros((s,), dtype),
            jnp.full((s,), -1, _I32),
        ),
    )
    cols2 = jax.lax.broadcasted_iota(_I32, (s, s), 1)
    hit = (roc[None, :] == rows2) & (cols2 < n)
    return jnp.max(jnp.where(hit, cols2, -1), axis=1)


def _fold_kernel(
    ctab_ref,   # [C, C*D, D] sentinel cost table (-1 where unusable)
    conf_ref,   # [C*D] confident-voter flag per observation
    dok_ref,    # [C, D] i32 detection usable
    ds_ref,     # [S, Cp] i32 out: detection of each hypothesis per camera
    cnt_ref,    # [2] i32 out: (n_hyp, n_dropped)
    *,
    cams: int,
    d: int,
    h: int,
    s: int,
    cp: int,
    gate: float,
    max_cost: float,
    clip: float,
    tie_eps: float,
    invalid_cost: float,
):
    dtype = ctab_ref.dtype
    n = max(h, d)  # the JV's square size (ops.hungarian pads to it)
    lanes = jnp.arange(s, dtype=_I32)
    rows2 = jax.lax.broadcasted_iota(_I32, (s, s), 0)  # hypothesis
    cols2 = jax.lax.broadcasted_iota(_I32, (s, s), 1)  # detection
    cam2 = jax.lax.broadcasted_iota(_I32, (s, cp), 1)
    det_real = lanes < d

    def camera(c, carry):
        ds, n0, n_drop = carry
        dok = plgpu.load(dok_ref.at[c, lanes], mask=det_real, other=0) > 0

        # Cost assembly (:344-381): sum each hypothesis' observations of
        # the earlier cameras. Unobserved slots load the -1 sentinel.
        def observe(c1, acc):
            total, used, votes_conf, votes_all = acc
            slot = jnp.sum(jnp.where(cam2 == c1, ds, 0), axis=1, dtype=_I32)
            on = slot >= 0
            obs = c1 * d + jnp.maximum(slot, 0)
            ct = plgpu.load(
                ctab_ref.at[c, obs[:, None], lanes[None, :]],
                mask=on[:, None] & det_real[None, :],
                other=-1.0,
            )
            conf = plgpu.load(conf_ref.at[obs], mask=on, other=0.0) > 0
            big = (ct > gate).astype(_I32)
            return (
                total + jnp.maximum(ct, 0.0),
                used + (ct >= 0).astype(_I32),
                votes_conf + big * conf[:, None].astype(_I32),
                votes_all + big,
            )

        zf = jnp.zeros((s, s), dtype)
        zi = jnp.zeros((s, s), _I32)
        total, used, votes_conf, votes_all = jax.lax.fori_loop(
            0, c, observe, (zf, zi, zi, zi)
        )
        n_obs_used = used.astype(dtype)
        n_obs = jnp.sum((ds >= 0).astype(_I32), axis=1, dtype=_I32)
        cost = total / jnp.maximum(n_obs_used, 1.0)
        n_votes = jnp.where(
            (n_obs == 1)[:, None], votes_all, votes_conf
        ).astype(dtype)
        n_obs_f = jnp.maximum(n_obs, 1).astype(dtype)
        veto = n_votes / n_obs_f[:, None] > (1.0 - 1.0 / (2.0 * n_obs_f))[
            :, None
        ]
        unusable = (n_obs_used < 0.5) | (n_obs == 0)[:, None]
        cost = jnp.where(unusable, max_cost, cost)
        veto = veto | unusable
        cost = jnp.where(dok[None, :], cost, max_cost)
        veto = veto | ~dok[None, :]
        mask = ~veto & (cost < gate)

        need = (
            jnp.max(jnp.sum(mask.astype(_I32), axis=0, dtype=_I32)) > 1
        ) | (jnp.max(jnp.sum(mask.astype(_I32), axis=1, dtype=_I32)) > 1)
        first = jnp.min(jnp.where(mask, cols2, s), axis=1)
        from_mask = jnp.where(first < s, first, -1)

        def from_solver():
            clipped = jnp.minimum(cost, clip)
            tie = jnp.where(
                clipped >= clip,
                clip
                + tie_eps
                * (rows2.astype(dtype) + 1.0)
                * (cols2.astype(dtype) + 1.0),
                clipped,
            )
            tie = jnp.where(dok[None, :], tie, invalid_cost)
            sq = jnp.where((rows2 < h) & (cols2 < d), tie, 0.0)
            col = _jv(sq, n, s)
            return jnp.where((lanes < h) & (col < d), col, -1)

        assignment = jax.lax.cond(need, from_solver, lambda: from_mask)

        # Interpret the assignment (:636-673), as fusion._associate_camera.
        A = assignment[:, None] == cols2
        assigned_valid = _any(A & dok[None, :], 1)
        pair_ok = _any(A & mask, 1)
        extend = assigned_valid & pair_ok
        spawn_hyp = (assigned_valid & ~pair_ok).astype(_I32)
        det_of_hyp = jnp.sum(jnp.where(A, cols2, 0), axis=1, dtype=_I32)
        handled = _any(A & assigned_valid[:, None], 0)
        spawn_det = (dok & ~handled).astype(_I32)

        slot1 = n0 + jnp.cumsum(spawn_hyp, dtype=_I32) - 1
        n1 = n0 + jnp.sum(spawn_hyp, dtype=_I32)
        slot2 = n1 + jnp.cumsum(spawn_det, dtype=_I32) - 1
        n2 = n1 + jnp.sum(spawn_det, dtype=_I32)
        det_to_slot = jnp.max(
            jnp.where(A & (spawn_hyp > 0)[:, None], slot1[:, None], -1),
            axis=0,
        )
        det_to_slot = jnp.where(spawn_det > 0, slot2, det_to_slot)
        S = (det_to_slot[None, :] == rows2) & (rows2 < h)
        spawn_on = _any(S, 1)
        spawned = jnp.sum(jnp.where(S, cols2, 0), axis=1, dtype=_I32)
        # Column c is still unobserved (-1): no camera is folded twice.
        new_col = jnp.where(
            extend, det_of_hyp, jnp.where(spawn_on, spawned, -1)
        )
        ds = jnp.where(cam2 == c, new_col[:, None], ds)
        return (
            ds,
            jnp.minimum(n2, h),
            n_drop + jnp.maximum(n2 - h, 0),
        )

    ds, n_hyp, n_drop = jax.lax.fori_loop(
        0,
        cams,
        camera,
        (
            jnp.full((s, cp), -1, _I32),
            jnp.asarray(0, _I32),
            jnp.asarray(0, _I32),
        ),
    )
    ds_ref[...] = ds
    two = jnp.arange(2, dtype=_I32)
    cnt_ref[...] = jnp.where(two == 0, n_hyp, n_drop)


def fold_shape(h_cap: int, d: int, cams: int):
    """(S, Cp, num_warps): the kernel's padded tile sizes for H hypothesis
    slots, D detections per camera and C cameras."""
    s = pl.next_power_of_2(max(h_cap, d) + 1)
    cp = pl.next_power_of_2(cams)
    # One warp holds a 16 x 16 tile at 8 values a thread; wider tiles get
    # more warps, up to 8 (the [S, S] accumulators stay in registers).
    num_warps = max(1, min(8, s * max(s, cp) // 256))
    return s, cp, num_warps


@functools.partial(
    jax.jit,
    static_argnames=(
        "h_cap", "gate", "max_cost", "clip", "tie_eps", "invalid_cost",
        "interpret",
    ),
)
def associate_fold_batched(
    ctab,
    conf_obs,
    det_ok,
    *,
    h_cap: int,
    gate: float,
    max_cost: float,
    clip: float,
    tie_eps: float,
    invalid_cost: float,
    interpret: bool = False,
):
    """The association fold of B frames, one kernel program per frame.

    Args:
      ctab: [B, C, C*D, D] sentinel cost tables (fusion.associate layout).
      conf_obs: [B, C*D] confident-voter flags (0/1).
      det_ok: [B, C, D] bool.
      interpret: run the Pallas interpreter (CPU tests); never implied.

    Returns:
      (det_slot [B, H, C] i32, n_hyp [B] i32, n_dropped [B] i32).
    """
    b, cams, x, d = ctab.shape
    s, cp, num_warps = fold_shape(h_cap, d, cams)
    kernel = functools.partial(
        _fold_kernel,
        cams=cams, d=d, h=h_cap, s=s, cp=cp, gate=gate, max_cost=max_cost,
        clip=clip, tie_eps=tie_eps, invalid_cost=invalid_cost,
    )
    ds, counts = pl.pallas_call(
        kernel,
        grid=(b,),
        in_specs=[
            pl.BlockSpec((None, cams, x, d), lambda i: (i, 0, 0, 0)),
            pl.BlockSpec((None, x), lambda i: (i, 0)),
            pl.BlockSpec((None, cams, d), lambda i: (i, 0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, s, cp), lambda i: (i, 0, 0)),
            pl.BlockSpec((None, 2), lambda i: (i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((b, s, cp), _I32),
            jax.ShapeDtypeStruct((b, 2), _I32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        interpret=interpret,
        name="association_fold",
    )(ctab, conf_obs.astype(ctab.dtype), det_ok.astype(_I32))
    return ds[:, :h_cap, :cams], counts[:, 0], counts[:, 1]


def make_associate_fold(interpret: bool = False, **static):
    """A single-frame fold (ctab [C, C*D, D], conf_obs [C*D], det_ok [C, D])
    whose vmap launches the batched kernel once (the chunked `lax.map` of
    the offline pipeline). `static`: the keyword arguments of
    associate_fold_batched."""

    @jax.custom_batching.custom_vmap
    def fold(ctab, conf_obs, det_ok):
        ds, nh, nd = associate_fold_batched(
            ctab[None], conf_obs[None], det_ok[None],
            interpret=interpret, **static,
        )
        return ds[0], nh[0], nd[0]

    @fold.def_vmap
    def _vmap_rule(axis_size, in_batched, ctab, conf_obs, det_ok):
        def bcast(x, batched):
            return x if batched else jnp.broadcast_to(
                x, (axis_size,) + x.shape
            )

        out = associate_fold_batched(
            bcast(ctab, in_batched[0]),
            bcast(conf_obs, in_batched[1]),
            bcast(det_ok, in_batched[2]),
            interpret=interpret, **static,
        )
        return out, (True, True, True)

    return fold
