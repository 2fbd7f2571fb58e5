"""Multi-chip sharding of the pipeline over a jax.sharding.Mesh.

The reference scales by running more ROS nodes/threads on one machine; the
scale-out here instead exploits the pipeline's structure:

* The fusion stage (association + triangulation) is *stateless per frame* —
  frames are data-parallel. The `data` mesh axis shards the time/batch axis
  of a replayed sequence (or, online, a batch of in-flight frames from
  independent capture volumes).
* Within a frame, the hypothesis/person axis carries the triangulation
  FLOPs (people x joints x sigma-points DLT solves) — the `model` mesh axis
  shards it via sharding constraints, and XLA inserts the (small)
  all-gathers where the association scan or the merge pass needs the full
  hypothesis set.
* The temporal stages (tracking + prior LM) are sequential across frames by
  construction (a `lax.scan` with a small carry) and run replicated — they
  are a negligible fraction of per-frame compute.

Everything uses GSPMD (`jax.jit` with NamedSharding + sharding constraints)
rather than hand-written collectives; XLA hands the collectives to NCCL. The
cards of one host are joined all to all by NVLink, so the mesh shape
follows the algorithm (frames on `data`, hypotheses on `model`), not a
physical topology.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from smartedgesensor3dhumanpose_tpu import fusion, pipeline, tracking
from smartedgesensor3dhumanpose_tpu import types as types_lib
from smartedgesensor3dhumanpose_tpu.config import PipelineConfig
from smartedgesensor3dhumanpose_tpu.types import CameraRig, Frame, TrackerState


def make_mesh(
    n_devices: Optional[int] = None,
    data: Optional[int] = None,
    model: int = 1,
) -> Mesh:
    """A (data, model) mesh over the first n_devices devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"data*model ({data}*{model}) != n_devices ({n})")
    dev = np.asarray(devices[:n]).reshape(data, model)
    return Mesh(dev, ("data", "model"))


def _constrain(tree, mesh: Mesh, spec: P):
    sharding = NamedSharding(mesh, spec)

    def one(a):
        if a.ndim == 0:
            return a
        # Truncate the spec to the leaf's rank (low-rank leaves like
        # per-frame scalars only take the leading axes) and pad the rest
        # with replication.
        lead = list(spec)[: a.ndim]
        full = P(*(lead + [None] * (a.ndim - len(lead))))
        return jax.lax.with_sharding_constraint(a, NamedSharding(mesh, full))

    return jax.tree.map(one, tree)


def fuse_frame_sharded(
    frame: Frame,
    rig: CameraRig,
    config: PipelineConfig,
    mesh: Mesh,
    axis: str = "model",
    unroll_cameras: bool = True,
):
    """ONE frame's fusion with WITHIN-frame sharding over a mesh axis.

    This is the scale-out path for the 64-camera x 25-person configuration
    (SURVEY section 2): the per-camera normalization runs sharded over the
    camera axis, the normalized keypoints are all_gathered (small) before
    the sequential greedy association, and the FLOP-heavy per-hypothesis
    triangulation + unscented covariance runs sharded over the hypothesis
    axis. XLA inserts the collectives; equivalence and the presence of the
    all-gather in the compiled HLO are asserted in tests/test_sharding.py.
    """
    def hook(tag, tree):
        if tag in ("camera_inputs", "hypotheses"):
            return _constrain(tree, mesh, P(axis))
        # pre_association / persons: the greedy scan and the sequential
        # merge consume the full set -> replicate (the all_gather point).
        return _constrain(tree, mesh, P())

    return fusion.fuse_frame(
        frame,
        rig,
        config.fusion,
        unroll_cameras=unroll_cameras,
        sharding_hook=hook,
    )


def run_offline_sharded(
    rig: CameraRig,
    config: PipelineConfig,
    mesh: Mesh,
    frames: Frame,
    state: TrackerState,
):
    """Whole-sequence pipeline with frame-parallel fusion over the mesh.

    Args:
      frames: Frame pytree with a leading time axis on every field.
      state: initial TrackerState (replicated).

    Returns:
      (final_state, StepOutput with leading time axis) — the same results as
      pipeline.Pipeline.run_offline, computed with the fusion stage sharded
      over the `data` axis and the hypothesis axis constrained to `model`.
    """
    frame_sharding = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())

    def program(frames: Frame, state: TrackerState):
        # ---- stage 1: data-parallel fusion over the time axis.
        def fuse_one(frame):
            frame, pivot = pipeline.mask_stale_cameras(
                frame, config.fusion.max_sync_diff
            )
            persons, n_drop = fusion.fuse_frame(
                frame, rig, config.fusion, with_stats=True
            )
            return persons, pivot, n_drop

        persons, pivots, n_dropped_hyp = jax.vmap(fuse_one)(frames)
        # Shard frames over `data` and the person axis over `model`.
        persons = _constrain(persons, mesh, P("data", "model"))

        # ---- stage 1b: batched cold-start LM smoothing (the dominant
        # per-frame compute) — data-parallel over frames, person axis on
        # `model` (see tracking.smooth_cold / pipeline._scan_impl).
        pre = jax.vmap(lambda p: tracking.smooth_cold(p, config.prior))(
            persons
        )
        pre = _constrain(pre, mesh, P("data", "model"))

        # ---- stage 2: sequential tracking scan (small, replicated).
        persons = _constrain(persons, mesh, P())
        pre = _constrain(pre, mesh, P())

        state_out, track_outs = pipeline.track_frames(
            state, persons, pivots, frames.fb_delay, pre, config
        )

        # ---- stage 3: data-parallel reprojection feedback.
        pred = _constrain(track_outs.fused_pred, mesh, P("data", "model"))
        feedback = pipeline.reproject_frames(
            pred, track_outs.pred_delta_t, frames.cam_stamp, rig, config
        )
        c = frames.cam_stamp.shape[-1]
        bbox_c, bbox_s = jax.vmap(types_lib.person_bbox3d)(
            track_outs.fused.xyz, track_outs.fused.score, track_outs.fused.valid
        )

        return state_out, pipeline.StepOutput(
            persons_raw=persons,
            fused=track_outs.fused,
            fused_pred=track_outs.fused_pred,
            feedback=feedback,
            pred_delta_t=track_outs.pred_delta_t,
            pivot_stamp=pivots,
            ts_per_cam=frames.cam_stamp,
            fb_delay_per_cam_raw=frames.fb_delay,
            fb_delay_per_cam=jnp.broadcast_to(
                track_outs.pred_delta_t[:, None],
                (track_outs.pred_delta_t.shape[0], c),
            ),
            bbox3d_center=bbox_c,
            bbox3d_size=bbox_s,
            n_dropped_hypotheses=n_dropped_hyp,
            n_dropped_track_spawns=track_outs.n_dropped_spawns,
        )

    fn = jax.jit(
        program,
        in_shardings=(
            jax.tree.map(lambda _: frame_sharding, frames),
            jax.tree.map(lambda _: rep, state),
        ),
    )
    return fn(frames, state)
