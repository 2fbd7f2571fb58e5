"""Benchmark: fused 3D skeleton frames/sec on the 16-cam x 6-person demo.

Replays a synthetic hall sequence (the reference's poses2D_16cam.bag
equivalent, io.synthetic) through the full pipeline — association,
triangulation + UT covariance, LM smoothing, tracking/prediction, per-camera
reprojection feedback — as one compiled program on the GPU, plus context
sections: online step latency, the live synced loop, the adversarial scene,
the 64-camera x 25-person hall with its per-stage split, and the on-device
parity artifacts (parity.py).

Prints ONE JSON line:
  {"metric": ..., "value": fps, "unit": "frames/s", "device": {...}, ...}
`device` names the platform, device kind and count as JAX reports them and
the card's name and power limit as nvidia-smi reports them. The process
exits non-zero, after printing the line, when JAX finds no GPU or when any
section failed (its error is in the line).

`python bench.py --compare-assoc` instead times the association fold
implementations ("triton", "cond_while") against each other on the four
workloads of PERF.md and prints their ms/frame.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import jax
import numpy as np

from smartedgesensor3dhumanpose_tpu import compile_cache


def device_stamp() -> dict:
    """The device the numbers were taken on."""
    devices = jax.devices()
    stamp = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    try:
        stamp["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        stamp["nvidia_smi"] = f"unavailable: {type(e).__name__}"
    return stamp


class _Sections:
    """Runs named sections; a failure is recorded, printed, and fails the
    run at the end instead of hiding behind a null."""

    def __init__(self):
        self.errors = {}

    def run(self, name, fn, *args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            self.errors[name] = f"{type(e).__name__}: {e}"
            traceback.print_exc(file=sys.stderr)
            return None


def _timed_reps(fn, n_rep):
    """Seconds per call of `fn()` with `n_rep` calls dispatched back to back
    and blocked on together (the steady state of a continuous replay)."""
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    outs = [fn() for _ in range(n_rep)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / n_rep


def _demo_config(**fusion_overrides):
    from smartedgesensor3dhumanpose_tpu.config import (
        FusionConfig,
        PipelineConfig,
        TrackerConfig,
    )

    return PipelineConfig(
        fusion=FusionConfig(
            num_cameras=16,
            max_dets_per_cam=6,
            max_hypotheses=12,
            max_epipolar_error=0.045,
            **fusion_overrides,
        ),
        tracker=TrackerConfig(max_tracks=12),
    )


def _scene_frames(num_cameras, num_people, num_frames, seed):
    from smartedgesensor3dhumanpose_tpu.io import synthetic
    from smartedgesensor3dhumanpose_tpu.types import Frame

    scene = synthetic.generate_scene(
        synthetic.SceneConfig(
            num_cameras=num_cameras,
            num_people=num_people,
            num_frames=num_frames,
            seed=seed,
        )
    )
    return scene, Frame.from_arrays(synthetic.frames_from_scene(scene))


def run_bench(result: dict, sections: _Sections) -> None:
    from smartedgesensor3dhumanpose_tpu import metrics, skeleton
    from smartedgesensor3dhumanpose_tpu import pipeline as pl
    from smartedgesensor3dhumanpose_tpu.config import PipelineConfig

    num_frames = 256
    scene, frames = _scene_frames(16, 6, num_frames, seed=42)
    config = _demo_config()
    # fusion_batch=128: the 256-frame sequence in two chunks.
    pipe = pl.Pipeline(scene["rig"], config, fusion_batch=128)
    state = pipe.init_state()  # run_offline does not donate: reused

    # ---- offline throughput: all reps dispatched, blocked once.
    dt = _timed_reps(lambda: pipe.run_offline(state, frames), 5)
    result["value"] = round(num_frames / dt, 2)
    _, outs = pipe.run_offline(state, frames)

    # ---- accuracy vs the scene's ground truth after the tracker's publish
    # gate has warmed: MPJPE, PCK@0.15, misses, scored-joint coverage.
    ev = metrics.evaluate_sequence(
        outs.fused.xyz,
        outs.fused.score,
        outs.fused.valid,
        scene["gt_xyz"],
        to_fusion=np.asarray(
            skeleton.input_model(config.fusion.pose_method).to_fusion
        ),
        start=num_frames // 4,
    )
    errs = ev.joint_errors
    result["mpjpe_mm"] = round(metrics.mpjpe(errs) * 1e3, 3)
    result["pck_0.15"] = round(metrics.pck(errs, 0.15), 4)
    result["gt_miss_rate"] = round(ev.miss_rate, 4)
    result["joint_coverage"] = round(ev.coverage, 4)

    def online_latency():
        # Per-call wall clock of the donating online step, host dispatch
        # included.
        st, out = pipe.step(
            pipe.init_state(), jax.tree.map(lambda a: a[0], frames)
        )
        jax.block_until_ready(out)
        lat = []
        for i in range(30):
            fr = jax.tree.map(lambda a: a[i % num_frames], frames)
            t0 = time.perf_counter()
            st, out = pipe.step(st, fr)
            jax.block_until_ready(out)
            lat.append(time.perf_counter() - t0)
        result["p50_step_latency_ms"] = round(float(np.median(lat)) * 1e3, 3)

    sections.run("p50_step_latency_ms", online_latency)

    def live_sync():
        # Per-camera messages -> native ApproximateTimeSync -> latest-wins
        # slot -> device step in one process (the reference's topology,
        # skeleton_3d_triang_mult_node.cpp:999-1025,1216-1224); e2e = the
        # newest contributing message's arrival -> step done.
        import os
        import tempfile

        from smartedgesensor3dhumanpose_tpu import online
        from smartedgesensor3dhumanpose_tpu.io import replay as replay_lib

        live_scene, _ = _scene_frames(16, 6, 64, seed=43)
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "live.jsonl")
            replay_lib.save_jsonl(path, live_scene)
            msgs = list(replay_lib.load_jsonl_messages(path))
        _, _, report = online.run_online_synced(
            pipe.step,
            pipe.init_state(),
            msgs,
            num_cameras=16,
            max_dets=6,
            message_interval_s=1.0 / (30.0 * 16),  # 30 Hz sensors x 16 cams
        )
        result["e2e_ms_p50"] = round(report.e2e_ms_p50, 3)
        result["live_sync"] = {
            "frames_synced": report.frames_synced,
            "processed": report.processed_frames,
            "slot_dropped": report.slot_dropped,
        }

    sections.run("live_sync", live_sync)

    def chain_step():
        # The online step chained in one compiled scan: no per-call host
        # dispatch, so wall / K is the device time of a step. The chain
        # donates its state; each call gets a fresh one, made before the
        # clock starts. Min over 3 calls of the mean over K steps.
        k = num_frames
        jax.block_until_ready(pipe.run_per_frame_chain(pipe.init_state(),
                                                       frames))
        best = float("inf")
        for _ in range(3):
            st0 = jax.block_until_ready(pipe.init_state())
            t0 = time.perf_counter()
            jax.block_until_ready(pipe.run_per_frame_chain(st0, frames))
            best = min(best, (time.perf_counter() - t0) / k * 1e3)
        result["chain_step_ms_min_of_means"] = round(best, 4)

    sections.run("chain_step_ms_min_of_means", chain_step)

    def adversarial():
        # Ghost detections + identity swaps + correlated occlusions
        # (io/synthetic.py knobs): the JV solves on most camera steps here.
        import parity as parity_lib
        from smartedgesensor3dhumanpose_tpu.types import Frame

        a_scene, a_data, a_config = parity_lib._full_scene_and_config(True)
        a_frames = Frame.from_arrays(a_data)
        a_pipe = pl.Pipeline(a_scene["rig"], a_config, fusion_batch=32)
        a_state = a_pipe.init_state()
        dt = _timed_reps(lambda: a_pipe.run_offline(a_state, a_frames), 5)
        result["adversarial_fps"] = round(
            a_frames.cam_stamp.shape[0] / dt, 2
        )
        return a_pipe.run_offline(a_state, a_frames)[1]

    a_out = sections.run("adversarial_fps", adversarial)

    def scaled():
        # The 64-camera x 25-person hall; fusion_batch=4.
        from smartedgesensor3dhumanpose_tpu import profiling

        s_frames = 256
        s_scene, sf = _scene_frames(64, 25, s_frames, seed=1)
        s_pipe = pl.Pipeline(
            s_scene["rig"], PipelineConfig.scaled_64cam(), fusion_batch=4
        )
        s_state = s_pipe.init_state()
        dt = _timed_reps(lambda: s_pipe.run_offline(s_state, sf), 3)
        result["scaled_64cam_25people_fps"] = round(s_frames / dt, 2)
        result["scaled_stage_ms"] = {
            k: round(v, 4)
            for k, v in profiling.profile_stages(s_pipe, sf, reps=3).items()
        }

    sections.run("scaled_64cam_25people_fps", scaled)

    def demo_stages():
        from smartedgesensor3dhumanpose_tpu import profiling

        result["stage_ms"] = {
            k: round(v, 4)
            for k, v in profiling.profile_stages(pipe, frames, reps=3).items()
        }

    sections.run("stage_ms", demo_stages)

    # ---- on-device parity artifacts (parity.py).
    import pytest

    import parity as parity_lib

    def reference_parity():
        try:
            result.update(parity_lib.run_parity())
        except pytest.skip.Exception as e:
            # Needs the reference C++ tree and a toolchain next to the
            # checkout; absent, the section records why it did not run.
            result["parity_skipped"] = str(e)

    sections.run("parity", reference_parity)
    sections.run(
        "full_parity", lambda: result.update(parity_lib.run_full_parity())
    )
    if a_out is not None:
        # The adversarial section above ran exactly this differential's
        # device pipeline; reuse its outputs.
        sections.run(
            "adversarial_parity",
            lambda: result.update(
                parity_lib.run_full_parity(
                    adversarial=True, prefix="adversarial_parity", outs=a_out
                )
            ),
        )


def compare_association(result: dict, sections: _Sections) -> None:
    """ms/frame of each association fold implementation in four workloads,
    measured in turns (kernel, XLA, XLA, kernel) within this process."""
    import dataclasses

    import parity as parity_lib
    from smartedgesensor3dhumanpose_tpu import pipeline as pl
    from smartedgesensor3dhumanpose_tpu.config import PipelineConfig
    from smartedgesensor3dhumanpose_tpu.types import Frame

    def with_impl(config, impl):
        return dataclasses.replace(
            config,
            fusion=dataclasses.replace(config.fusion, assignment_impl=impl),
        )

    scene16, frames16 = _scene_frames(16, 6, 256, seed=42)
    a_scene, a_data, a_config = parity_lib._full_scene_and_config(True)
    # 16 frames of the hall: the XLA folds take seconds per frame there.
    scene64, frames64 = _scene_frames(64, 25, 16, seed=1)
    workloads = {
        "offline_16x6": (scene16["rig"], _demo_config(), frames16, 128,
                         "offline"),
        "adversarial_16x6": (a_scene["rig"], a_config,
                             Frame.from_arrays(a_data), 32, "offline"),
        "offline_64x25": (scene64["rig"], PipelineConfig.scaled_64cam(),
                          frames64, 4, "offline"),
        "chain_16x6": (scene16["rig"], _demo_config(), frames16, 128,
                       "chain"),
    }
    out = {}
    for name, (rig, config, frames, batch, mode) in workloads.items():
        n = int(frames.cam_stamp.shape[0])
        impls = ("triton", "cond_while")
        pipes = {
            impl: pl.Pipeline(rig, with_impl(config, impl), fusion_batch=batch)
            for impl in impls
        }

        def once(impl):
            p = pipes[impl]
            if mode == "chain":
                st = jax.block_until_ready(p.init_state())
                t0 = time.perf_counter()
                jax.block_until_ready(p.run_per_frame_chain(st, frames))
            else:
                st = p.init_state()
                t0 = time.perf_counter()
                jax.block_until_ready(p.run_offline(st, frames))
            return (time.perf_counter() - t0) / n * 1e3

        row = {}
        for impl in impls:
            t0 = time.perf_counter()
            sections.run(f"{name}/{impl}/compile", once, impl)
            row[f"{impl}_compile_and_first_s"] = round(
                time.perf_counter() - t0, 1
            )
        times = {impl: [] for impl in impls}
        for impl in impls + impls[::-1]:  # in turns
            ms = sections.run(f"{name}/{impl}", once, impl)
            if ms is not None:
                times[impl].append(ms)
        for impl, ms in times.items():
            if ms:
                row[f"{impl}_ms_per_frame"] = round(min(ms), 4)
        out[name] = row
        print(json.dumps({name: row}), file=sys.stderr, flush=True)
    result["association_ms_per_frame"] = out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--compare-assoc", action="store_true",
                   help="time the association fold implementations")
    args = p.parse_args(argv)

    compile_cache.enable()
    result = {
        "metric": "fused_3d_skeleton_fps_16cam_6people",
        "value": None,
        "unit": "frames/s",
        "device": device_stamp(),
    }
    sections = _Sections()
    if result["device"]["platform"] != "gpu":
        sections.errors["device"] = "no GPU: JAX's default device is " + (
            result["device"]["platform"]
        )
    elif args.compare_assoc:
        result["metric"] = "association_fold_ms_per_frame"
        result["unit"] = "ms/frame"
        compare_association(result, sections)
    else:
        sections.run("offline_fps", run_bench, result, sections)
    if sections.errors:
        result["errors"] = sections.errors
    print(json.dumps(result))
    return 1 if sections.errors else 0


if __name__ == "__main__":
    sys.exit(main())
