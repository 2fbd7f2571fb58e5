"""Fully-fused end-to-end variant: camera images -> 3D skeletons on one chip.

The reference splits the system across hardware: 2D CNNs on edge sensors,
fusion on a desktop, connected by a network with ~100 ms feedback latency
(README.md:7-11, g_avg_delay skeleton_3d_triang_mult_node.cpp:63). When all
camera streams reach one accelerator, the detector (models.keypoint_cnn),
multi-view fusion, LM smoothing/tracking and reprojection feedback fuse into
a single XLA program per frame — the end-to-end variant of BASELINE.json.
"""

from __future__ import annotations

import functools
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from smartedgesensor3dhumanpose_tpu import pipeline as pl
from smartedgesensor3dhumanpose_tpu.config import PipelineConfig
from smartedgesensor3dhumanpose_tpu.models import keypoint_cnn
from smartedgesensor3dhumanpose_tpu.types import CameraRig, Frame, TrackerState


def end_to_end_step(
    state: TrackerState,
    images: jnp.ndarray,
    cam_stamp: jnp.ndarray,
    params: Any,
    model: keypoint_cnn.KeypointCNN,
    det_cfg: keypoint_cnn.DetectorConfig,
    rig: CameraRig,
    config: PipelineConfig,
) -> Tuple[TrackerState, pl.StepOutput]:
    """One fused frame: [C, H, W, 3] images -> detector -> fusion -> tracker
    -> feedback. Jittable end to end (close over model/det_cfg/rig/config)."""
    kp2d, cov2d, det_score, det_valid = keypoint_cnn.detect(
        model, params, images, det_cfg
    )
    dtype = kp2d.dtype
    c = images.shape[0]
    frame = Frame(
        kp2d=kp2d,
        cov2d=cov2d,
        det_score=det_score,
        det_valid=det_valid,
        cam_stamp=cam_stamp,
        # On-chip detection has no sensor feedback loop to measure; the
        # prediction horizon falls back to the configured average delay.
        fb_delay=jnp.full((c,), -1.0, dtype),
    )
    return pl.step(state, frame, rig=rig, config=config)


def make_end_to_end(
    rig: CameraRig,
    config: PipelineConfig,
    det_cfg: keypoint_cnn.DetectorConfig,
    rng_key,
):
    """Build (jitted_step, model, params, initial_state)."""
    model, params = keypoint_cnn.init_detector(det_cfg, rng_key)
    step = jax.jit(
        functools.partial(
            end_to_end_step,
            model=model,
            det_cfg=det_cfg,
            rig=rig,
            config=config,
        )
    )
    state = TrackerState.initial(
        config.tracker.max_tracks,
        config.tracker.n_mov_avg,
        config.tracker.avg_delay,
    )
    return step, model, params, state
