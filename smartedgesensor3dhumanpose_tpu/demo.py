"""Demo runner: the `roslaunch pose_prior pose_triangulate_demo.launch`
equivalent (README.md:40-49).

Replays the 16-camera / 6-person hall sequence (synthetic, or a recorded
NPZ/JSONL via io.replay) through the full pipeline and reports the
per-detection-count timing buckets the reference prints at shutdown.

Usage:
  python -m smartedgesensor3dhumanpose_tpu.demo                 # offline scan
  python -m smartedgesensor3dhumanpose_tpu.demo --online        # per-frame
  python -m smartedgesensor3dhumanpose_tpu.demo --jsonl f.jsonl # replay file
  python -m smartedgesensor3dhumanpose_tpu.demo --viz out.png   # dashboard
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def build_demo(num_cameras: int, num_people: int, num_frames: int, seed: int):
    from smartedgesensor3dhumanpose_tpu import pipeline
    from smartedgesensor3dhumanpose_tpu.config import (
        FusionConfig,
        PipelineConfig,
        TrackerConfig,
    )
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
    config = PipelineConfig(
        fusion=FusionConfig(
            num_cameras=num_cameras,
            max_dets_per_cam=num_people,
            max_hypotheses=2 * num_people,
            max_epipolar_error=0.045,
        ),
        tracker=TrackerConfig(max_tracks=2 * num_people),
    )
    data = synthetic.frames_from_scene(scene)
    frames = Frame.from_arrays(data)
    return scene, config, frames, pipeline.Pipeline(scene["rig"], config)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--cameras", type=int, default=16)
    parser.add_argument("--people", type=int, default=6)
    parser.add_argument("--frames", type=int, default=128)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--online", action="store_true",
                        help="latest-wins producer/consumer loop instead of "
                             "the offline scan")
    parser.add_argument("--feed-hz", type=float, default=30.0,
                        help="producer rate for --online (sensor frame rate)")
    parser.add_argument("--closed-loop", action="store_true",
                        help="close the semantic-feedback loop through "
                             "virtual edge sensors: fb_delay is MEASURED "
                             "from each frame's reprojection feedback "
                             "round-trip instead of the open-loop constant")
    parser.add_argument("--loop-network-latency", type=float, default=0.03,
                        help="sensor downlink latency (s) for --closed-loop")
    parser.add_argument("--loop-processing-latency", type=float, default=0.05,
                        help="capture->feedback-emission latency (s) for "
                             "--closed-loop")
    parser.add_argument("--jsonl", type=str, default=None,
                        help="replay a recorded JSONL through the native "
                             "approximate-time synchronizer")
    parser.add_argument("--record-jsonl", type=str, default=None,
                        help="record the (synthetic) scene as a JSONL "
                             "message stream (the bag-recording equivalent; "
                             "replay it with --jsonl)")
    parser.add_argument("--live", type=str, default=None,
                        help="write an animated operator dashboard of the "
                             "replay (.gif or scrubbable .html)")
    parser.add_argument("--viz", type=str, default=None,
                        help="write a dashboard PNG of the last frame")
    parser.add_argument("--save", type=str, default=None,
                        help="write fused outputs to this NPZ")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="save final tracker state here")
    parser.add_argument("--vis-cov", action="store_true",
                        help="track + report 3D sigma statistics (the "
                             "reference's vis_cov shutdown dump)")
    parser.add_argument("--eval", action="store_true",
                        help="report MPJPE / PCK vs the synthetic scene's "
                             "ground truth (offline synthetic replay only)")
    args = parser.parse_args(argv)

    from smartedgesensor3dhumanpose_tpu import checkpoint, timing
    from smartedgesensor3dhumanpose_tpu.types import Frame

    scene, config, frames, pipe = build_demo(
        args.cameras, args.people, args.frames, args.seed
    )

    if args.record_jsonl:
        from smartedgesensor3dhumanpose_tpu.io import replay as replay_lib

        replay_lib.save_jsonl(args.record_jsonl, scene)
        print(f"scene recorded to {args.record_jsonl}")

    if args.jsonl:
        import os

        from smartedgesensor3dhumanpose_tpu.io import replay as replay_lib

        if not os.path.exists(args.jsonl):
            parser.error(
                f"--jsonl: no such recording: {args.jsonl} "
                "(create one with --record-jsonl)"
            )

    if args.jsonl and not args.online:
        from smartedgesensor3dhumanpose_tpu.io import replay as replay_lib

        packed = list(
            replay_lib.replay_jsonl(
                args.jsonl, args.cameras, args.people
            )
        )
        print(f"replayed {len(packed)} synchronized frames from {args.jsonl}")
        frames = Frame(
            kp2d=jnp.asarray(np.stack([f["kp2d"] for f in packed])),
            cov2d=jnp.asarray(np.stack([f["cov2d"] for f in packed])),
            det_score=jnp.asarray(np.stack([f["det_score"] for f in packed])),
            det_valid=jnp.asarray(np.stack([f["det_valid"] for f in packed])),
            cam_stamp=jnp.asarray(
                np.stack([f["cam_stamp"] for f in packed]), jnp.float32
            ),
            fb_delay=jnp.asarray(np.stack([f["fb_delay"] for f in packed])),
        )

    n = frames.kp2d.shape[0]
    state = pipe.init_state()
    buckets = timing.TimingBuckets("Pipeline")

    if args.closed_loop:
        # Closed feedback loop (BASELINE.json configs[2]): virtual edge
        # sensors receive each frame's Reprojection2D (with the echoed
        # original stamps, skeleton_reproj_mult_node.cpp:157-159,233-234),
        # measure fb_delay = arrival - orig_stamp, and feed it into the next
        # frame — the tracker's prediction horizon converges to the real
        # loop latency instead of assuming 0.1 s.
        from smartedgesensor3dhumanpose_tpu.io import sensors as sensors_lib

        sensors = sensors_lib.VirtualSensorArray(
            args.cameras, network_latency=args.loop_network_latency
        )
        # Warm up with a throwaway state (the jitted step donates its state
        # argument).
        _, out0 = pipe.step(
            pipe.init_state(), jax.tree.map(lambda a: a[0], frames)
        )
        jax.block_until_ready(out0)
        t0 = time.perf_counter()
        final_state, last, report = sensors_lib.run_closed_loop(
            pipe.step,
            state,
            frames,
            sensors,
            processing_latency=args.loop_processing_latency,
        )
        dt = time.perf_counter() - t0
        loop_latency = args.loop_processing_latency + args.loop_network_latency
        for _ in range(n):
            buckets.add(dt / n, 0)
        print(
            f"closed loop: {n} frames, {report.n_feedback_received} feedback "
            f"deliveries; injected loop latency "
            f"{loop_latency * 1e3:.0f} ms -> pred_delta_t converged to "
            f"{report.pred_delta_t[-1] * 1e3:.1f} ms "
            f"(start {report.pred_delta_t[0] * 1e3:.1f} ms)"
        )
        outs = None
    elif args.online and args.jsonl:
        # FULL live topology in one process (reference
        # skeleton_3d_triang_mult_node.cpp:999-1025,1216-1224): raw
        # per-camera JSONL messages -> native ApproximateTimeSync ->
        # latest-wins slot -> jitted device step, with sync-stage and
        # slot-stage drop accounting.
        from smartedgesensor3dhumanpose_tpu import online
        from smartedgesensor3dhumanpose_tpu.io import replay as replay_lib

        _, out = pipe.step(
            pipe.init_state(), jax.tree.map(lambda a: a[0], frames)
        )
        jax.block_until_ready(out)

        final_state, last, report = online.run_online_synced(
            pipe.step,
            state,
            list(replay_lib.load_jsonl_messages(args.jsonl)),
            num_cameras=args.cameras,
            max_dets=args.people,
            message_interval_s=1.0 / (args.feed_hz * args.cameras),
        )
        for ms in report.step_ms:
            buckets.add(ms / 1e3, 0)
        print(
            f"online+sync: {report.produced_messages} messages -> "
            f"{report.frames_synced} synchronized frames "
            f"({report.messages_unconsumed} messages unconsumed at sync), "
            f"{report.processed_frames} stepped, {report.slot_dropped} "
            f"dropped at the slot (latest-wins); p50 step "
            f"{report.step_ms_p50:.2f} ms, p50 sync-input->output "
            f"{report.e2e_ms_p50:.2f} ms"
        )
        outs = None
    elif args.online:
        # Latest-wins producer/consumer loop (reference worker handoff,
        # skeleton_3d_triang_mult_node.cpp:999-1025): a producer thread
        # feeds synchronized frames at --feed-hz into the native LatestSlot;
        # the consumer drains the newest and steps the device. Backlogged
        # frames are dropped, keeping output fresh under compute overload.
        from smartedgesensor3dhumanpose_tpu import online

        _, out = pipe.step(
            pipe.init_state(), jax.tree.map(lambda a: a[0], frames)
        )
        jax.block_until_ready(out)

        final_state, last, report = online.run_online(
            pipe.step,
            state,
            frames,
            feed_interval_s=1.0 / args.feed_hz,
        )
        for ms in report.step_ms:
            buckets.add(ms / 1e3, 0)
        print(
            f"online: {len(report.processed_handles)}/{report.produced} "
            f"frames processed, {report.dropped} dropped (latest-wins), "
            f"p50 step {report.step_ms_p50:.2f} ms"
        )
        outs = None
    else:
        t0 = time.perf_counter()
        final_state, outs = pipe.run_offline(state, frames)
        jax.block_until_ready(outs)
        compile_and_run = time.perf_counter() - t0
        t0 = time.perf_counter()
        final_state, outs = pipe.run_offline(state, frames)
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        fps = n / dt
        print(f"compile+first-run: {compile_and_run:.1f}s")
        print(f"offline replay: {n} frames in {dt*1e3:.1f} ms "
              f"-> {fps:.0f} fused frames/s")
        for t in range(n):
            n_det = int(np.asarray(outs.fused.valid[t]).sum())
            buckets.add(dt / n, n_det)
        last = jax.tree.map(lambda a: a[-1], outs)

    print(buckets.report())
    if args.vis_cov and outs is not None:
        from smartedgesensor3dhumanpose_tpu import viz

        stats = viz.SigmaStats()
        for t in range(n):
            stats.update(
                np.asarray(outs.fused.cov[t]), np.asarray(outs.fused.score[t])
            )
        print(stats.report())
    valid = np.asarray(last.fused.valid)
    ids = np.asarray(last.fused.person_id)[valid]
    print(f"last frame: {valid.sum()} fused persons published, ids={sorted(ids.tolist())}")

    # Ground truth exists only for the synthetic scene (a JSONL replay may
    # come from anywhere; the reference evaluates GT out-of-repo too).
    have_gt = not args.jsonl
    if args.eval:
        if outs is None or not have_gt:
            print("--eval requires the offline synthetic replay (no GT here)")
        else:
            from smartedgesensor3dhumanpose_tpu import metrics, skeleton

            # GT joints are in the configured input model's layout: derive
            # the 17->21 selection from the pipeline config rather than
            # hardcoding SIMPLE_MODEL (would silently mis-map under h36m).
            model = skeleton.input_model(config.fusion.pose_method)
            errs = metrics.sequence_joint_errors(
                outs.fused.xyz,
                outs.fused.score,
                outs.fused.valid,
                scene["gt_xyz"],
                to_fusion=np.asarray(model.to_fusion),
                start=n // 4,  # skip the tracker publish-gate warm-up
            )
            print(
                f"eval vs GT (frames {n // 4}-{n - 1}): "
                f"MPJPE {metrics.mpjpe(errs) * 1e3:.1f} mm, "
                f"PCK@0.15m {metrics.pck(errs, 0.15) * 100:.1f}%, "
                f"PCK@0.05m {metrics.pck(errs, 0.05) * 100:.1f}% "
                f"({errs.size} matched joints)"
            )

    if args.viz:
        from smartedgesensor3dhumanpose_tpu import viz

        viz.render_frame_summary(
            last,
            scene["rig"],
            args.viz,
            input_frame=(
                jax.tree.map(lambda a: a[-1], frames)
                if outs is not None
                else None
            ),
            # GT layer only when the rendered output IS the last synthetic
            # frame (online modes publish whichever frame survived the
            # latest-wins slot).
            gt_xyz=(
                scene["gt_xyz"][n - 1] if have_gt and outs is not None
                else None
            ),
            pose_method=config.fusion.pose_method,
        )
        print(f"dashboard written to {args.viz}")
    if args.live and outs is not None:
        from smartedgesensor3dhumanpose_tpu import viz

        viz.render_live_dashboard(
            outs, scene["rig"], args.live, input_frames=frames
        )
        print(f"live dashboard written to {args.live}")
    elif args.live:
        print(
            "--live requires the offline replay outputs; it is not "
            "available with --online (no dashboard written)"
        )
    if args.save and outs is not None:
        np.savez_compressed(
            args.save,
            fused_xyz=np.asarray(outs.fused.xyz),
            fused_score=np.asarray(outs.fused.score),
            fused_valid=np.asarray(outs.fused.valid),
            person_id=np.asarray(outs.fused.person_id),
        )
        print(f"outputs written to {args.save}")
    if args.checkpoint:
        checkpoint.save_tracker_state(args.checkpoint, final_state)
        print(f"tracker state written to {args.checkpoint}")


if __name__ == "__main__":
    main()
