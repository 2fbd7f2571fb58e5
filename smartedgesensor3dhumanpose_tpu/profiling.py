"""Per-stage pipeline profiler (dispatch-defogged wall times).

The reference self-measures with per-node wall-time accumulators dumped at
shutdown (skeleton_3d_triang_mult_node.cpp:39-41,1234-1241 — reproduced by
`timing.TimingBuckets`). This module is the development-facing complement:
it times each OFFLINE pipeline stage in isolation on the current backend —
fusion (association + triangulation), cold-start LM smoothing, the
sequential tracker, reprojection feedback — plus the fused end-to-end
program, using pipelined repetitions (dispatch all reps, block once) so the
number reported is device time, not host-dispatch latency.

Each stage is the very function `pipeline.Pipeline._scan_impl` composes
(`pipeline.fuse_frames`, `smooth_frames`, `track_frames`,
`reproject_frames`), jitted on its own; `full` is the real `run_offline`,
so `full` vs the stage sum also exposes what XLA fusion across stage
boundaries buys.

CLI:
    python -m smartedgesensor3dhumanpose_tpu.profiling            # 16-cam demo
    python -m smartedgesensor3dhumanpose_tpu.profiling --big      # 64-cam hall
    python -m smartedgesensor3dhumanpose_tpu.profiling --json
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import jax

from smartedgesensor3dhumanpose_tpu import pipeline as pl
from smartedgesensor3dhumanpose_tpu.config import PipelineConfig
from smartedgesensor3dhumanpose_tpu.types import Frame


def _timeit(fn, *args, reps: int) -> float:
    """Seconds per call: warm once, then pipeline `reps` dispatches and
    block on all of them."""
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(reps)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / reps


def profile_stages(
    pipe: pl.Pipeline, frames: Frame, reps: int = 5
) -> Dict[str, float]:
    """Time each offline stage of `pipe` on `frames`.

    Returns {stage: milliseconds per frame}; stages are `fuse`,
    `smooth_cold`, `tracker`, `reproj`, and `full` (= run_offline, the
    number bench.py's throughput derives from).
    """
    config = pipe.config
    rig = pipe.rig
    batch = pipe._fusion_batch
    num_frames = int(frames.cam_stamp.shape[0])

    stage_fuse = jax.jit(lambda fr: pl.fuse_frames(fr, rig, config, batch))
    stage_smooth = jax.jit(lambda p: pl.smooth_frames(p, config, batch))
    stage_track = jax.jit(
        lambda s, p, pv, fb, pr: pl.track_frames(s, p, pv, fb, pr, config)
    )
    stage_reproj = jax.jit(
        lambda pred, dt, ts: pl.reproject_frames(pred, dt, ts, rig, config)
    )

    state = pipe.init_state()
    per_frame_ms = {}

    persons, pivots, _ = stage_fuse(frames)
    per_frame_ms["fuse"] = _timeit(stage_fuse, frames, reps=reps)

    pre = stage_smooth(persons)
    per_frame_ms["smooth_cold"] = _timeit(stage_smooth, persons, reps=reps)

    _, track_outs = stage_track(state, persons, pivots, frames.fb_delay, pre)
    per_frame_ms["tracker"] = _timeit(
        stage_track, state, persons, pivots, frames.fb_delay, pre, reps=reps
    )

    per_frame_ms["reproj"] = _timeit(
        stage_reproj,
        track_outs.fused_pred,
        track_outs.pred_delta_t,
        frames.cam_stamp,
        reps=reps,
    )

    per_frame_ms["full"] = _timeit(
        pipe.run_offline, pipe.init_state(), frames, reps=reps
    )

    return {k: v / num_frames * 1e3 for k, v in per_frame_ms.items()}


def device_event_summary(trace_dir: str, top: int = 25) -> Dict:
    """Reduce a `jax.profiler` trace to device numbers.

    For every device plane (`/device:...`): the traced window, the busy time
    (union of the intervals in which an operation ran) and the events
    counted by name, the `top` most frequent with their summed durations.
    """
    import collections
    import glob
    import os

    paths = glob.glob(
        os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
    )
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        spans, count, dur = [], collections.Counter(), collections.Counter()
        for line in plane.lines:
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                count[ev.name] += 1
                dur[ev.name] += ev.duration_ns
        if not spans:
            continue
        spans.sort()
        busy, end = 0.0, spans[0][0]
        for lo, hi in spans:
            if hi > end:
                busy += hi - max(lo, end)
                end = hi
        window = spans[-1][1] - spans[0][0]
        out[plane.name] = {
            "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "events": sum(count.values()),
            "top": [
                {"name": n, "count": c, "ms": dur[n] / 1e6}
                for n, c in count.most_common(top)
            ],
        }
    return out


def trace_online_steps(pipe: pl.Pipeline, frames: Frame, trace_dir: str,
                       steps: int = 8) -> Dict:
    """Trace `steps` online `Pipeline.step` calls (after a warm-up) and
    summarize the device events; counts are per step."""
    at = lambda t: jax.tree.map(lambda a: a[t], frames)  # noqa: E731
    st, out = pipe.step(pipe.init_state(), at(0))
    jax.block_until_ready(out)
    jax.profiler.start_trace(trace_dir)
    try:
        for t in range(1, steps + 1):
            st, out = pipe.step(st, at(t))
            jax.block_until_ready(out)
    finally:
        jax.profiler.stop_trace()
    summary = device_event_summary(trace_dir)
    for dev in summary.values():
        dev["events_per_step"] = dev["events"] / steps
        for row in dev["top"]:
            row["per_step"] = row["count"] / steps
    return summary


def _demo_inputs(big: bool, batch: int | None, num_frames: int | None):
    from smartedgesensor3dhumanpose_tpu.config import (
        FusionConfig,
        TrackerConfig,
    )
    from smartedgesensor3dhumanpose_tpu.io import synthetic

    if big:
        f = num_frames or 128
        cams, people = 64, 25
        config = PipelineConfig.scaled_64cam()
        batch = batch or 4
    else:
        f = num_frames or 256
        cams, people = 16, 6
        config = PipelineConfig(
            fusion=FusionConfig(
                num_cameras=16,
                max_dets_per_cam=6,
                max_hypotheses=12,
                max_epipolar_error=0.045,
            ),
            tracker=TrackerConfig(max_tracks=12),
        )
        batch = batch or 128
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(
            num_cameras=cams, num_people=people, num_frames=f, seed=1
        )
    )
    data = synthetic.frames_from_scene(scene)
    frames = Frame.from_arrays(data)
    return pl.Pipeline(scene["rig"], config, fusion_batch=batch), frames


def main(argv=None) -> None:
    import argparse
    import json

    from smartedgesensor3dhumanpose_tpu import compile_cache

    compile_cache.enable()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--big", action="store_true",
                   help="64-camera x 25-person scaled hall")
    p.add_argument("--batch", type=int, default=None,
                   help="fusion chunk size (defaults per config)")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--json", action="store_true", help="one JSON line")
    p.add_argument("--trace-online", metavar="DIR", default=None,
                   help="trace 8 online steps into DIR and print the "
                        "device-event summary instead")
    p.add_argument("--assignment-impl", default="auto",
                   help="FusionConfig.assignment_impl of the run")
    args = p.parse_args(argv)

    pipe, frames = _demo_inputs(args.big, args.batch, args.frames)
    if args.assignment_impl != "auto":
        cfg = pipe.config
        cfg = dataclasses.replace(cfg, fusion=dataclasses.replace(
            cfg.fusion, assignment_impl=args.assignment_impl))
        pipe = pl.Pipeline(pipe.rig, cfg, fusion_batch=pipe._fusion_batch)
    if args.trace_online:
        print(json.dumps(trace_online_steps(pipe, frames, args.trace_online)))
        return
    stages = profile_stages(pipe, frames, reps=args.reps)
    if args.json:
        print(json.dumps(
            {"config": "64x25" if args.big else "16x6",
             "unit": "ms/frame", **{k: round(v, 4) for k, v in stages.items()}}
        ))
    else:
        for k, v in stages.items():
            print(f"{k:>12}: {v:8.4f} ms/frame")
        fps = 1e3 / stages["full"]
        print(f"{'throughput':>12}: {fps:8.1f} frames/s")


if __name__ == "__main__":
    main()
