"""Differential tests for the Pallas-Triton association-fold kernel.

Oracle: fusion.associate's pure-XLA cond_while fold (itself differentially
tested against the compiled reference C++ in
test_reference_parity_frame.py). The kernel runs in the Pallas interpreter
(explicit `interpret=True`), at the suite's float64 like the oracle; the
compared outputs are the INTEGER association results (which detection each
hypothesis observes per camera) and the data they gather, which must be
identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smartedgesensor3dhumanpose_tpu import cameras as cameras_lib
from smartedgesensor3dhumanpose_tpu import fusion
from smartedgesensor3dhumanpose_tpu.config import FusionConfig
from smartedgesensor3dhumanpose_tpu.io import synthetic


def _scene_inputs(num_cameras, num_people, num_frames, seed, **kw):
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(
            num_cameras=num_cameras,
            num_people=num_people,
            num_frames=num_frames,
            seed=seed,
            pixel_noise=2.0,
            keypoint_dropout=0.08,
            detection_dropout=0.05,
            **kw,
        )
    )
    data = synthetic.frames_from_scene(scene)
    return scene["rig"], data


def _associate_inputs(rig, data, ti, config):
    kp2d = jnp.asarray(data["kp2d"][ti])
    cov2d = jnp.asarray(data["cov2d"][ti])
    det_score = jnp.asarray(data["det_score"][ti])
    det_valid = jnp.asarray(data["det_valid"][ti])
    kp_n, cov_n, kp_ok = cameras_lib.normalize_keypoints(
        kp2d, cov2d, rig.K, config.min_kp_score
    )
    enough = jnp.sum(kp_ok, axis=-1) > (config.num_input_joints // 2)
    return kp_n, cov_n, det_score, det_valid & enough


def _run(impl, kp_n, cov_n, det_score, det_ok, rig, config):
    cfg = dataclasses.replace(config, assignment_impl=impl)
    hyps = fusion.associate(
        kp_n, cov_n, det_score, det_ok, rig, cfg,
        interpret=impl == "triton",
    )
    return jax.tree_util.tree_map(np.asarray, hyps)


@pytest.mark.parametrize("scenario", ["benign", "ghosts"])
def test_fused_scan_matches_xla_scan(scenario):
    kw = (
        dict(num_ghost_slots=2, ghost_rate=0.6)
        if scenario == "ghosts"
        else {}
    )
    rig, data = _scene_inputs(6, 3, 4, seed=11, **kw)
    config = FusionConfig(
        num_cameras=6,
        max_dets_per_cam=int(data["kp2d"].shape[2]),
        max_hypotheses=16,
    )
    for ti in range(int(data["kp2d"].shape[0])):
        inputs = _associate_inputs(rig, data, ti, config)
        want = _run("cond_while", *inputs, rig, config)
        got = _run("triton", *inputs, rig, config)
        np.testing.assert_array_equal(
            got.cam_mask, want.cam_mask, err_msg=f"{scenario} t{ti}"
        )
        # Same detection in every observed slot -> identical gathered data.
        np.testing.assert_allclose(
            got.kp, want.kp, rtol=0, atol=0, err_msg=f"{scenario} t{ti}"
        )
        np.testing.assert_array_equal(got.obs_score, want.obs_score)
        assert int(got.n_hyp) == int(want.n_hyp), (scenario, ti)
        assert int(got.n_dropped) == int(want.n_dropped), (scenario, ti)


def test_fused_scan_batched_matches_per_frame():
    """The custom_vmap batched dispatch (the offline pipeline path, one
    kernel program per frame) equals frame-by-frame single calls."""
    rig, data = _scene_inputs(5, 3, 5, seed=3)
    config = FusionConfig(
        num_cameras=5,
        max_dets_per_cam=int(data["kp2d"].shape[2]),
        max_hypotheses=12,
        assignment_impl="triton",
    )
    frames = [
        _associate_inputs(rig, data, ti, config)
        for ti in range(int(data["kp2d"].shape[0]))
    ]
    stacked = [jnp.stack(x) for x in zip(*frames)]

    def one(kp_n, cov_n, det_score, det_ok):
        return fusion.associate(
            kp_n, cov_n, det_score, det_ok, rig, config, interpret=True
        )

    batched = jax.vmap(one)(*stacked)
    for ti, f in enumerate(frames):
        single = one(*f)
        np.testing.assert_array_equal(
            np.asarray(batched.cam_mask[ti]),
            np.asarray(single.cam_mask),
            err_msg=f"t{ti}",
        )
        np.testing.assert_allclose(
            np.asarray(batched.kp[ti]), np.asarray(single.kp), rtol=0, atol=0
        )
        assert int(batched.n_hyp[ti]) == int(single.n_hyp)


def test_fused_scan_overflow_counts():
    """Over-capacity frames count dropped spawns exactly like the XLA fold."""
    rig, data = _scene_inputs(4, 6, 2, seed=7)
    config = FusionConfig(
        num_cameras=4,
        max_dets_per_cam=int(data["kp2d"].shape[2]),
        max_hypotheses=4,  # far below the spawn demand
    )
    for ti in range(2):
        inputs = _associate_inputs(rig, data, ti, config)
        want = _run("cond_while", *inputs, rig, config)
        got = _run("triton", *inputs, rig, config)
        assert int(got.n_dropped) == int(want.n_dropped) > 0, ti
        np.testing.assert_array_equal(got.cam_mask, want.cam_mask)
