"""The full closed-loop pipeline as one jitted per-frame program.

Replaces the reference's three-process ROS graph (skeleton_3d -> pose_prior ->
pose_reprojection connected by topics, pose_triangulate_demo.launch:11-29)
with a single pure function

    step(tracker_state, frame) -> (tracker_state, StepOutput)

containing fusion (association + triangulation), prior smoothing + tracking +
prediction, and per-camera reprojection feedback — all stages fuse into one
XLA program per frame, with buffer reuse handled by the compiler instead of
pub/sub queues. Offline replay runs the whole sequence in a single
`lax.scan` for maximum throughput; online use calls the jitted `step`
per frame.

Per-frame camera staleness masking (cameras more than max_sync_diff behind
the pivot stamp are dropped for the frame, reference
skeleton_3d_triang_mult_node.cpp:1049-1057) happens on-device at the top of
the step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from smartedgesensor3dhumanpose_tpu import fusion, reprojection, tracking
from smartedgesensor3dhumanpose_tpu.config import PipelineConfig
from smartedgesensor3dhumanpose_tpu.types import (
    CameraRig,
    Frame,
    Persons3D,
    Reprojection2D,
    TrackerState,
    person_bbox3d,
)


class StepOutput(NamedTuple):
    persons_raw: Persons3D     # persons_3d (triangulation output)
    fused: Persons3D           # persons3d_fused
    fused_pred: Persons3D      # persons3d_fused_pred
    feedback: Reprojection2D   # cam_*/skel_pred
    pred_delta_t: jnp.ndarray  # predicted feedback latency
    pivot_stamp: jnp.ndarray   # frame timestamp (newest camera)
    # PersonCovList header fields (person_msgs/PersonCovList.msg:1-4):
    # per-camera original stamps echoed on every published list
    # (skeleton_3d_triang_mult_node.cpp:1062, pose_prior_mult_node.cpp:530)
    # and the measured / predicted per-camera feedback delays — raw measured
    # values ride on persons_3d (:1063), the broadcast predicted horizon on
    # the fused lists (pose_prior_mult_node.cpp:531).
    ts_per_cam: jnp.ndarray           # [C]
    fb_delay_per_cam_raw: jnp.ndarray  # [C] measured (persons_3d)
    fb_delay_per_cam: jnp.ndarray      # [C] predicted (persons3d_fused*)
    # PersonCov 3D bounding box of the fused persons (PersonCov.msg:7-8).
    bbox3d_center: jnp.ndarray        # [P, 3]
    bbox3d_size: jnp.ndarray          # [P, 3]
    # Overflow observability: spawns lost to the fixed slot capacities this
    # frame (the reference's vectors grow unboundedly,
    # skeleton_3d_triang_mult_node.cpp:662-673 / pose_prior_mult_node.cpp:
    # 570-580; here crowded frames warn via monitor instead of silently
    # losing people).
    n_dropped_hypotheses: jnp.ndarray   # [] int32
    n_dropped_track_spawns: jnp.ndarray  # [] int32


def mask_stale_cameras(frame: Frame, max_sync_diff: float) -> Tuple[Frame, jnp.ndarray]:
    """Drop cameras lagging the pivot (newest) stamp (:1029-1057)."""
    pivot = jnp.max(frame.cam_stamp)
    fresh = (pivot - frame.cam_stamp) <= max_sync_diff
    return (
        frame._replace(det_valid=frame.det_valid & fresh[:, None]),
        pivot,
    )


def step(
    state: TrackerState,
    frame: Frame,
    rig: CameraRig,
    config: PipelineConfig,
) -> Tuple[TrackerState, StepOutput]:
    """One full pipeline frame (pure; jit with static config/rig closure)."""
    frame, pivot = mask_stale_cameras(frame, config.fusion.max_sync_diff)

    persons_raw, n_dropped_hyp = fusion.fuse_frame(
        frame, rig, config.fusion, with_stats=True
    )

    state, track_out = tracking.step(
        state,
        persons_raw,
        pivot.astype(persons_raw.xyz.dtype),
        frame.fb_delay,
        config.prior,
        config.tracker,
    )

    feedback = reprojection.reproject(
        track_out.fused_pred,
        rig,
        config.prior.pose_method,
        track_out.pred_delta_t,
        ut_kappa=config.fusion.ut_kappa,
        ts_per_cam=frame.cam_stamp,
    )

    c = frame.cam_stamp.shape[0]
    bbox_c, bbox_s = person_bbox3d(
        track_out.fused.xyz, track_out.fused.score, track_out.fused.valid
    )
    return state, StepOutput(
        persons_raw=persons_raw,
        fused=track_out.fused,
        fused_pred=track_out.fused_pred,
        feedback=feedback,
        pred_delta_t=track_out.pred_delta_t,
        pivot_stamp=pivot,
        ts_per_cam=frame.cam_stamp,
        fb_delay_per_cam_raw=frame.fb_delay,
        fb_delay_per_cam=jnp.broadcast_to(track_out.pred_delta_t, (c,)),
        bbox3d_center=bbox_c,
        bbox3d_size=bbox_s,
        n_dropped_hypotheses=n_dropped_hyp,
        n_dropped_track_spawns=track_out.n_dropped_spawns,
    )


def fuse_frames(
    frames: Frame, rig: CameraRig, config: PipelineConfig, batch: int
):
    """Offline stage 1: stale-camera masking + fusion of every frame of a
    sequence, `batch` frames at a time (the frame axis is vmapped inside a
    chunk, so the association fold launches once per chunk). Returns
    (persons_raw, pivots, n_dropped_hypotheses) with a leading time axis."""

    def fuse_one(frame):
        frame, pivot = mask_stale_cameras(frame, config.fusion.max_sync_diff)
        persons, n_drop = fusion.fuse_frame(
            frame, rig, config.fusion, unroll_cameras=True, with_stats=True
        )
        return persons, pivot, n_drop

    # Chunked batching: full vmap over a long sequence materializes the
    # sigma-point/leave-one-out intermediates for every frame at once
    # (O(T x H x J x 5C) tensors — hundreds of MB for T ~ 256); chunks
    # keep device memory bounded while still amortizing kernel launches.
    with jax.named_scope("fuse"):
        return jax.lax.map(fuse_one, frames, batch_size=batch)


def smooth_frames(persons: Persons3D, config: PipelineConfig, batch: int):
    """Offline stage 2: the cold-start LM smoothing of every frame. It is
    frame-independent (see tracking.smooth_cold), so it runs batched over
    the sequence and the sequential tracker carries only the cheap
    association / velocity / gating ops."""
    with jax.named_scope("smooth_cold"):
        return jax.lax.map(
            lambda p: tracking.smooth_cold(p, config.prior),
            persons,
            batch_size=batch,
        )


def track_frames(
    state: TrackerState,
    persons: Persons3D,
    pivots: jnp.ndarray,
    fb_delay: jnp.ndarray,
    pre,
    config: PipelineConfig,
):
    """Offline stage 3: the sequential tracker as a `lax.scan` of
    tracking.step over the precomputed smoothing."""

    def body(carry, xs):
        person_t, pivot_t, fb_t, pre_t = xs
        return tracking.step(
            carry,
            person_t,
            pivot_t.astype(person_t.xyz.dtype),
            fb_t,
            config.prior,
            config.tracker,
            precomputed=pre_t,
        )

    with jax.named_scope("tracker"):
        return jax.lax.scan(body, state, (persons, pivots, fb_delay, pre))


def reproject_frames(
    fused_pred: Persons3D,
    pred_delta_t: jnp.ndarray,
    cam_stamp: jnp.ndarray,
    rig: CameraRig,
    config: PipelineConfig,
) -> Reprojection2D:
    """Offline stage 4: per-camera reprojection feedback of every frame."""

    def one(pred_t, delta_t, ts_t):
        return reprojection.reproject(
            pred_t,
            rig,
            config.prior.pose_method,
            delta_t,
            ut_kappa=config.fusion.ut_kappa,
            ts_per_cam=ts_t,
        )

    with jax.named_scope("reproj"):
        return jax.vmap(one)(fused_pred, pred_delta_t, cam_stamp)


class Pipeline:
    """Convenience wrapper owning the rig + config with jit-compiled entry
    points.

    `step` is the online path (one frame in, outputs + carried state out);
    `run_offline` scans a whole pre-loaded sequence on device for maximum
    throughput (the bag-replay benchmarking mode).
    """

    def __init__(
        self,
        rig: CameraRig,
        config: PipelineConfig,
        fusion_batch: int = 64,
    ):
        self.rig = rig
        self.config = config
        self._fusion_batch = fusion_batch
        # The online entry points donate the tracker-state buffers: the
        # state is threaded linearly (state_out replaces state_in every
        # frame), so XLA updates it in place instead of allocating fresh
        # device buffers per step. Callers must not reuse a state after
        # passing it in (warm up with a throwaway init_state()).
        self._step_raw = functools.partial(step, rig=rig, config=config)
        self._step = jax.jit(self._step_raw, donate_argnums=(0,))
        self._scan = jax.jit(self._scan_impl)
        # The ONLINE step chained inside one compiled scan: identical math
        # to per-frame `step` calls, with no per-call host dispatch — wall
        # time / num_frames is the on-device per-step cost.
        self._chain = jax.jit(
            lambda s, fs: jax.lax.scan(self._step_raw, s, fs),
            donate_argnums=(0,),
        )

    def init_state(self, dtype=jnp.float32) -> TrackerState:
        t = self.config.tracker
        return TrackerState.initial(
            t.max_tracks, t.n_mov_avg, t.avg_delay, dtype=dtype
        )

    def step(self, state: TrackerState, frame: Frame):
        return self._step(state, frame)

    def _scan_impl(self, state: TrackerState, frames: Frame):
        """Offline throughput mode: the stateless stages run *batched over
        the whole sequence* (fusion and reprojection vmap over the time
        axis — one kernel launch sequence for all frames), and only the
        genuinely sequential tracker runs as a scan. Identical math to the
        per-frame step; drastically fewer sequential kernel launches."""
        config = self.config
        batch = self._fusion_batch
        persons, pivots, n_dropped_hyp = fuse_frames(
            frames, self.rig, config, batch
        )
        pre = smooth_frames(persons, config, batch)
        state, track_outs = track_frames(
            state, persons, pivots, frames.fb_delay, pre, config
        )
        feedback = reproject_frames(
            track_outs.fused_pred,
            track_outs.pred_delta_t,
            frames.cam_stamp,
            self.rig,
            config,
        )
        c = frames.cam_stamp.shape[-1]
        bbox_c, bbox_s = jax.vmap(person_bbox3d)(
            track_outs.fused.xyz, track_outs.fused.score, track_outs.fused.valid
        )
        return state, StepOutput(
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

    def run_offline(self, state: TrackerState, frames: Frame):
        """Process a stacked sequence (leading time axis on every Frame
        field) in one compiled program. Returns (final_state, StepOutput with
        a leading time axis)."""
        return self._scan(state, frames)

    def run_per_frame_chain(self, state: TrackerState, frames: Frame):
        """Sequential ONLINE steps chained in one compiled scan (no
        cross-frame fusion batching, unlike run_offline) — the device-time
        oracle for the online step latency. Donates `state`."""
        return self._chain(state, frames)
