"""Command-line runner (reference: examples/run_dso_{tum_mono,kitti,euroc}.cc).

    python -m ldso_tpu_torch.cli run --dataset tum --path /data/seq_01 \
        --preset default --output results.txt [--start 0 --end -1] \
        [--loop-closing 1] [--metrics metrics.jsonl] [--device cuda]

Port of ``ldso_tpu/cli.py``, flag for flag, plus ``--device`` (default
``cuda``; nothing falls back to the CPU unasked). Exports the trajectory
in TUM format (`timestamp tx ty tz qx qy qz qw`, camToWorld — reference:
FullSystem::printResult) and, when ground truth is available (synthetic
dataset), prints the ATE. Unlike the reference it stops its threads: every
run ends with ``finish_mapping()``, the loop worker's ``finish()`` and
``shutdown()``, also when a lost frame ends the loop early.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_system(args, ds):
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.system import FullSystem

    cfg = preset(args.preset)
    if args.seed:
        cfg = cfg.replace(seed=args.seed)
    img0, _, _ = ds.get_image(0)
    h, w = img0.shape
    system = FullSystem(cfg, ds.intrinsics(), w, h, device=args.device,
                        async_mapping=bool(args.async_pipeline),
                        pipeline_depth=args.pipeline_depth,
                        batch_size=args.batch)
    if args.loop_closing and cfg.loop.enabled:
        if args.async_pipeline:
            from ldso_tpu_torch.loop.closing import AsyncLoopClosing as LC
        else:
            from ldso_tpu_torch.loop.closing import LoopClosing as LC

        lc = LC(cfg, ds.intrinsics())
        system.on_keyframe = lc.on_keyframe
        system.loop_closing = lc
    return system


def _feed(args, ds, system, order) -> tuple:
    """Feed ``order`` to ``system`` and drain it; (frames fed, skipped,
    seconds)."""
    t0 = time.time()
    n_done = 0
    n_skipped = 0
    for k, i in enumerate(order):
        # realtime pacing + frame skip (reference: preset=1 playbackSpeed
        # enforcement in examples/run_dso_*.cc — when the engine falls
        # behind the sensor clock, frames are dropped, not queued)
        if args.playback_speed > 0 and k > 0:
            due = abs(ds.get_image(i)[1] - ds.get_image(order[0])[1]) \
                / args.playback_speed
            now = time.time() - t0
            if now > due + args.skip_slack:
                n_skipped += 1
                continue
            if now < due:
                time.sleep(due - now)
        img, ts, exp = ds.get_image(i)
        st = system.add_frame(img, ts, exp)
        n_done += 1
        if args.verbose:
            print(f"[{i}] {st.get('status')} rmse={st.get('rmse', 0):.2f}",
                  file=sys.stderr)
        if st["status"] == "lost":
            print(f"tracking LOST at frame {i}", file=sys.stderr)
            if not args.relocalize:
                break
    system.finish_mapping()
    if system.loop_closing is not None and hasattr(system.loop_closing, "finish"):
        system.loop_closing.finish()
    return n_done, n_skipped, time.time() - t0


def _stop(system, ds) -> None:
    """Join the mapping thread, the loop worker and the vocabulary retrain,
    and close the reader, whatever ended the feed."""
    try:
        system.shutdown()
    finally:
        lc = system.loop_closing
        try:
            if lc is not None:
                lc.finish_retrain()
                if hasattr(lc, "shutdown"):
                    lc.shutdown()
        finally:
            if hasattr(ds, "close"):
                ds.close()


def cmd_run(args) -> int:
    from ldso_tpu_torch import telemetry

    # the metrics file carries each frame's span times: record while running
    tracing = bool(args.metrics) and not telemetry.enabled()
    if tracing:
        telemetry.reset()
        telemetry.enable()
    try:
        return _run(args)
    finally:
        if tracing:
            telemetry.disable()


def _run(args) -> int:
    from ldso_tpu_torch.eval.ate import ate_rmse, write_tum_trajectory
    from ldso_tpu_torch.io.datasets import open_dataset

    ds = open_dataset(args.dataset, args.path, device=args.device)
    system = _build_system(args, ds)

    end = args.end if args.end > 0 else ds.num_frames
    if args.frames > 0:
        end = args.start + args.frames
    order = list(range(args.start, min(end, ds.num_frames)))
    if args.reverse:                      # reference: TUM runner reverse play
        order = order[::-1]

    try:
        n_done, n_skipped, wall = _feed(args, ds, system, order)
    finally:
        _stop(system, ds)

    ts_arr, poses = system.export_trajectory()
    if args.output:
        write_tum_trajectory(args.output, ts_arr, poses)
        print(f"wrote {len(poses)} poses -> {args.output}", file=sys.stderr)
    if args.metrics:
        system.write_metrics(args.metrics)

    if args.viz:
        from ldso_tpu_torch import viz

        np_gt = None
        if hasattr(ds, "gt_pose_c_w") and len(poses) > 1:
            ids = [fr.frame_id for fr in system.frames][: len(poses)]
            np_gt = np.stack([ds.gt_pose_c_w(i) for i in ids])
        viz.dump_trajectory(args.viz, poses, np_gt)
        n_pts = viz.dump_map(args.viz, system)
        print(f"viz: wrote trajectory + {n_pts}-point map -> {args.viz}",
              file=sys.stderr)

    summary = dict(frames=n_done, skipped=n_skipped,
                   fps=round(n_done / max(wall, 1e-9), 2),
                   keyframes=len(system.kfs), lost=system.is_lost)
    if hasattr(ds, "gt_pose_c_w") and len(poses) > 3:
        ids = [fr.frame_id for fr in system.frames][: len(poses)]
        gt = np.stack([ds.gt_pose_c_w(i) for i in ids])
        est_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in poses])
        gt_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in gt])
        rmse, _ = ate_rmse(est_c, gt_c, with_scale=True)
        summary["ate_rmse"] = round(float(rmse), 4)
    print(json.dumps(summary))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ldso_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="run odometry on a dataset")
    r.add_argument("--dataset", choices=["tum", "kitti", "euroc", "synthetic"],
                   required=True)
    r.add_argument("--path", default="", help="dataset root directory")
    r.add_argument("--preset", default="default",
                   help="default | realtime | fast | tiny (reference preset=0..3)")
    r.add_argument("--device", default="cuda",
                   help="torch device of the engine and of the readers' "
                        "undistortion (cuda | cuda:N | cpu)")
    r.add_argument("--start", type=int, default=0)
    r.add_argument("--end", type=int, default=-1)
    r.add_argument("--frames", type=int, default=0,
                   help="shorthand: end = start + frames")
    r.add_argument("--output", default="results.txt",
                   help="TUM-format trajectory output")
    r.add_argument("--metrics", default="",
                   help="JSONL per-frame metrics; turns the span recorder on "
                        "(ldso_tpu_torch.telemetry), and each line gains 'ms' "
                        "(the frame's milliseconds by span name) and 'counts' "
                        "(its counters, e.g. ba.trials / ba.accepted)")
    r.add_argument("--loop-closing", type=int, default=1)
    r.add_argument("--async", dest="async_pipeline", type=int, default=0,
                   help="1 = track ∥ map ∥ loop pipeline (reference thread model)")
    r.add_argument("--pipeline-depth", type=int, default=8,
                   help="frames of deferred tracking readback (async mode)")
    r.add_argument("--batch", type=int, default=1,
                   help=">1 = track+trace B frames per device dispatch")
    r.add_argument("--playback-speed", type=float, default=0.0,
                   help=">0 enforces realtime pacing at this multiple of "
                        "sensor rate, dropping frames when behind "
                        "(reference preset=1)")
    r.add_argument("--skip-slack", type=float, default=0.05,
                   help="seconds of lateness tolerated before skipping")
    r.add_argument("--reverse", action="store_true",
                   help="play the sequence backwards (reference TUM runner)")
    r.add_argument("--relocalize", type=int, default=1,
                   help="keep feeding frames after tracking loss and let "
                        "BoW relocalization recover (0 = stop like the "
                        "reference)")
    r.add_argument("--viz", default="",
                   help="directory for offline trajectory/map/depth dumps")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--verbose", action="store_true")
    r.set_defaults(fn=cmd_run)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
