"""Latest-wins online loop: backlog frames must be DROPPED, output stays
fresh (reference worker handoff, skeleton_3d_triang_mult_node.cpp:999-1025).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smartedgesensor3dhumanpose_tpu import online, pipeline, sync
from smartedgesensor3dhumanpose_tpu.io import synthetic
from smartedgesensor3dhumanpose_tpu.types import Frame
from test_pipeline import scene_frames, small_config


def _setup(n_frames=24):
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(
            num_cameras=4, num_people=2, num_frames=n_frames, seed=5
        )
    )
    cfg = small_config(4, 2)
    frames = scene_frames(scene, dtype=jnp.float64)
    pipe = pipeline.Pipeline(scene["rig"], cfg)
    return pipe, frames


@pytest.mark.parametrize("prefer_native", [True, False])
def test_online_drops_backlog_under_load(prefer_native):
    pipe, frames = _setup()
    state = pipe.init_state(dtype=jnp.float64)
    n = frames.kp2d.shape[0]

    # Warm the compile so the hook delay dominates the step time (with a
    # throwaway state: the step donates it).
    pipe.step(
        pipe.init_state(dtype=jnp.float64),
        jax.tree.map(lambda a: a[0], frames),
    )

    feed = 0.005
    slow = 0.025  # consumer ~5x slower than the producer

    st, out, report = online.run_online(
        pipe.step,
        state,
        frames,
        feed_interval_s=feed,
        consumer_hook=lambda h: time.sleep(slow),
        prefer_native_slot=prefer_native,
    )
    # Under 5x overload most frames must be dropped, not queued.
    assert report.dropped > 0, report
    assert report.dropped + len(report.processed_handles) == n
    # Output stays fresh: handles strictly increase and the final frame is
    # the last one produced.
    h = report.processed_handles
    assert all(a < b for a, b in zip(h, h[1:])), h
    assert h[-1] == n - 1
    assert out is not None and bool(np.isfinite(np.asarray(out.fused.xyz)).all())


def test_online_no_drops_when_fast():
    pipe, frames = _setup(n_frames=10)
    state = pipe.init_state(dtype=jnp.float64)
    # Warm the compile with a throwaway state: the step donates it.
    pipe.step(
        pipe.init_state(dtype=jnp.float64),
        jax.tree.map(lambda a: a[0], frames),
    )

    st, out, report = online.run_online(
        pipe.step, state, frames, feed_interval_s=0.05
    )
    # Consumer comfortably keeps up: every frame processed, none dropped.
    assert report.dropped == 0, report
    assert report.processed_handles == list(range(10))


def test_latest_slot_native_python_differential():
    if sync.native_lib() is None:
        pytest.skip("native runtime unavailable")
    nat = sync.NativeLatestSlot(3)
    py = sync.PyLatestSlot(3)
    rng = np.random.default_rng(0)
    for step in range(200):
        if rng.uniform() < 0.6:
            stamps = rng.integers(0, 1 << 40, size=3).tolist()
            handles = rng.integers(0, 1 << 30, size=3).tolist()
            nat.put(stamps, handles)
            py.put(stamps, handles)
        else:
            assert nat.take() == py.take(), step
        assert nat.dropped == py.dropped, step
    assert nat.dropped > 0  # fixture actually exercised overwrites


def _jsonl_messages(scene, tmp_path, name="scene.jsonl"):
    from smartedgesensor3dhumanpose_tpu.io import replay as replay_lib

    path = str(tmp_path / name)
    replay_lib.save_jsonl(path, scene)
    return path, list(replay_lib.load_jsonl_messages(path))


def test_online_synced_full_live_topology(tmp_path):
    """Per-camera messages -> native ApproximateTimeSync -> latest-wins slot
    -> device step, live in ONE process (reference
    skeleton_3d_triang_mult_node.cpp:999-1025,1216-1224) — and the emitted
    frame count matches the offline replay of the same recording (same
    policy, same order)."""
    from smartedgesensor3dhumanpose_tpu.io import replay as replay_lib

    scene = synthetic.generate_scene(
        synthetic.SceneConfig(num_cameras=4, num_people=2, num_frames=20,
                              seed=5)
    )
    cfg = small_config(4, 2)
    pipe = pipeline.Pipeline(scene["rig"], cfg)
    state = pipe.init_state(dtype=jnp.float64)
    path, messages = _jsonl_messages(scene, tmp_path)

    builder = lambda fd: online.default_frame_builder(fd, dtype=jnp.float64)
    # Warm the compile with one offline-packed frame.
    offline_frames = list(replay_lib.replay_jsonl(path, 4, 2))
    pipe.step(
        pipe.init_state(dtype=jnp.float64), builder(offline_frames[0])
    )

    st, out, report = online.run_online_synced(
        pipe.step,
        pipe.init_state(dtype=jnp.float64),
        messages,
        num_cameras=4,
        max_dets=2,
        message_interval_s=0.001,
        frame_builder=builder,
    )
    assert report.produced_messages == len(messages)
    # The live sync emits exactly what the offline replay of the same
    # recording emits (bit-identical candidate selection).
    assert report.frames_synced == len(offline_frames)
    assert report.processed_frames + report.slot_dropped == report.frames_synced
    # The stream tail is the only unconsumed remainder here (no overflow).
    assert 0 <= report.messages_unconsumed < 4 * 4
    # End-to-end (sync input -> step done) must dominate the bare step.
    assert report.e2e_ms_p50 >= report.step_ms_p50
    assert out is not None
    assert bool(np.isfinite(np.asarray(out.fused.xyz)).all())


def test_online_synced_drop_under_load_and_sync_overflow(tmp_path):
    """Slot-level drops under consumer overload AND sync-policy drops when
    one camera stalls (queue overflow, approximate_time_vec.h:191-214)."""
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(num_cameras=4, num_people=2, num_frames=24,
                              seed=6)
    )
    cfg = small_config(4, 2)
    pipe = pipeline.Pipeline(scene["rig"], cfg)
    state = pipe.init_state(dtype=jnp.float64)
    from smartedgesensor3dhumanpose_tpu.io import replay as replay_lib

    path, messages = _jsonl_messages(scene, tmp_path)
    builder = lambda fd: online.default_frame_builder(fd, dtype=jnp.float64)
    pipe.step(
        pipe.init_state(dtype=jnp.float64),
        builder(next(replay_lib.replay_jsonl(path, 4, 2))),
    )

    # Camera 0 goes silent for frames 6..17: the other deques overflow the
    # policy's queue_size and messages are dropped inside the synchronizer.
    t0 = scene["cam_stamp"][6].min()
    t1 = scene["cam_stamp"][17].max()
    stalled = [
        m for m in messages
        if not (m[0] == 0 and t0 <= m[1] <= t1)
    ]

    st, out, report = online.run_online_synced(
        pipe.step,
        pipe.init_state(dtype=jnp.float64),
        stalled,
        num_cameras=4,
        max_dets=2,
        message_interval_s=0.002,
        frame_builder=builder,
        consumer_hook=lambda h: time.sleep(0.05),  # force slot backlog
    )
    assert report.slot_dropped > 0, report
    # Sync-level loss: far more messages unconsumed than any stream tail
    # could explain (queue_size 3 x 4 cams).
    assert report.messages_unconsumed > 3 * 4, report
    assert report.frames_synced < 24
    assert report.processed_frames + report.slot_dropped == report.frames_synced
