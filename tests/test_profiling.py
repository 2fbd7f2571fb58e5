"""The per-stage profiler runs the real stage bodies and returns sane times.

CPU-sized smoke (tiny scene, 1 rep): the value of this test is that the
profiler's stage wiring stays in sync with pipeline.Pipeline._scan_impl —
it calls the same public stage functions, so an API drift breaks here
rather than silently in a session on the card.
"""

import jax.numpy as jnp

from smartedgesensor3dhumanpose_tpu import pipeline as pl
from smartedgesensor3dhumanpose_tpu import profiling
from smartedgesensor3dhumanpose_tpu.config import (
    FusionConfig,
    PipelineConfig,
    TrackerConfig,
)
from smartedgesensor3dhumanpose_tpu.io import synthetic
from smartedgesensor3dhumanpose_tpu.types import Frame


def test_profile_stages_smoke():
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(
            num_cameras=4, num_people=2, num_frames=4, seed=5
        )
    )
    data = synthetic.frames_from_scene(scene)
    frames = Frame(
        kp2d=jnp.asarray(data["kp2d"]),
        cov2d=jnp.asarray(data["cov2d"]),
        det_score=jnp.asarray(data["det_score"]),
        det_valid=jnp.asarray(data["det_valid"]),
        cam_stamp=jnp.asarray(data["cam_stamp"], jnp.float32),
        fb_delay=jnp.asarray(data["fb_delay"]),
    )
    config = PipelineConfig(
        fusion=FusionConfig(
            num_cameras=4, max_dets_per_cam=2, max_hypotheses=6
        ),
        tracker=TrackerConfig(max_tracks=6),
    )
    pipe = pl.Pipeline(scene["rig"], config, fusion_batch=2)

    stages = profiling.profile_stages(pipe, frames, reps=1)

    assert set(stages) == {"fuse", "smooth_cold", "tracker", "reproj", "full"}
    assert all(v > 0.0 for v in stages.values())
    # `full` is the real fused program; it cannot beat the heaviest isolated
    # stage by an implausible margin (sanity that the stages measure the
    # same workload; generous slack for CI noise).
    assert stages["full"] > 0.05 * max(
        stages["fuse"], stages["tracker"]
    )
