#!/usr/bin/env python3
"""Drive the port's FullSystem modes over the 640x480 bench sequence, or
over the 320x240 out-and-back loop sequence, on a CUDA card and print one
line per drive.

    python3 scripts/torch_async_modes.py [WORD ...]

Each WORD is a drive, run in the order given on a fresh FullSystem at
``preset("default")`` (the 120-frame bench sequence as ``chip_smoke.py``
renders it, unless ``loop=N`` came before):
  sync        synchronous
  drain       async_mapping, finish_mapping() after every frame (must equal
              sync to the last digit)
  free        async_mapping, free-running
  pipe        async_mapping, pipeline_depth=8
  batch       async_mapping, pipeline_depth=8, batch_size=4
  paced       async_mapping, one frame every 0.25 s
  sloop       synchronous, with a LoopClosing(train_after=4) attached
  aloop       async_mapping, with an AsyncLoopClosing(train_after=4)
  loop=N      not a drive: the drives after it run on bench.py's loop
              sequence (seed 5, out_and_back) rendered at N frames
              (``chip_smoke.py`` phases 5 and 6 (c) run 240)
  trace=A:B   not a drive: the drives after it also print one line per
              tracked frame A..B-1: its ref keyframe, the ref version it
              was tracked against and the newest at its decision, its KF
              score delta and the vote re-evaluated across swaps, the
              coarse RMSE, whether it became a keyframe, its step error,
              and how far from the true centre (aligned, in true steps)
              the constant-velocity prediction it was tracked from and the
              tracked pose landed
  dump=F,DIR  not a drive: the drives after it write the inputs and the
              result of frame F's tracking to DIR/track_<drive>_F.npz
              (replay them with scripts/parity_track_replay.py)
  si=SECONDS  not a drive: sets ``sys.setswitchinterval`` for the drives
              after it (how often CPython lets a waiting thread take the
              interpreter lock; default 0.005)
Default: sync drain free pipe batch. A line gives ATE (% of extent),
frames/s over the whole drive (host clock, drain included), keyframes,
suppressed wants, submit-to-pose latency, the wall time of keyframe builds
and, per keyframe, how many frames later its tracker-ref swap landed. A
drive with loop closure also gives the closures as (current, candidate)
keyframes' frame ids, the frames fed when each pose-graph run started and
ended, and the ATE with every keyframe the pose graph moved put back
where odometry left it (the ATE without the pose graph). Every drive ends
with its error profile: the largest aligned position error in each run of
20 frames, in % of the trajectory's extent, the five frames whose step
from the frame before departs most from the ground truth's (in units of
the median true step, after the same alignment) and the keyframes' frame
ids. The last line is the card's name and power limit.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {
    "sync": dict(),
    "drain": dict(async_mapping=True),
    "free": dict(async_mapping=True),
    "pipe": dict(async_mapping=True, pipeline_depth=8),
    "batch": dict(async_mapping=True, pipeline_depth=8, batch_size=4),
    "paced": dict(async_mapping=True),
    "sloop": dict(),
    "aloop": dict(async_mapping=True),
}


def _attach_loop_closing(name, cfg, ds, system) -> tuple:
    """A loop closer attached to ``system``, whose pose-graph runs record
    (frames fed at start, at end) in ``runs`` and, per keyframe they move,
    its pose before the first move in ``moved``."""
    import numpy as np

    from ldso_tpu_torch.loop.closing import AsyncLoopClosing, LoopClosing

    lc = (AsyncLoopClosing if name == "aloop" else LoopClosing)(cfg, ds.intrinsics(),
                                                                train_after=4)
    system.on_keyframe, system.loop_closing = lc.on_keyframe, lc
    run_pose_graph, runs, moved = lc.run_pose_graph, [], {}

    def traced_pose_graph(s):
        with s.state_lock:
            before = {k: kf.T_cw.copy() for k, kf in s.kfs.items()}
            f0 = s.frame_count
        run_pose_graph(s)
        with s.state_lock:
            for k, T in before.items():
                if k not in moved and not np.array_equal(s.kfs[k].T_cw, T):
                    moved[k] = T
            runs.append((f0, s.frame_count))

    lc.run_pose_graph = traced_pose_graph
    return lc, runs, moved


def _loop_report(cs, system, ds, lc, runs, moved) -> str:
    saved = {k: system.kfs[k].T_cw for k in moved}
    for k, T in moved.items():
        system.kfs[k].T_cw = T
    try:
        ate_odo = cs._ate_pct(system, ds)
    finally:
        for k, T in saved.items():
            system.kfs[k].T_cw = T
    fid = {k: kf.frame_id for k, kf in system.kfs.items()}
    return (f" | closures {[(fid[a], fid[b]) for a, b, _ in lc.loops_closed]}, pose-graph "
            f"runs at frames {runs}, {len(moved)} KFs moved, ATE without the pose graph "
            f"{ate_odo:.4f}%")


def _center(T):
    return -(T[:3, :3].T @ T[:3, 3])


def _alignment(system, ds) -> tuple:
    """(frame ids, estimated centres, true centres, Sim(3) alignment of the
    first onto the second as a function)."""
    import numpy as np

    from ldso_tpu_torch.eval.ate import umeyama

    _, poses = system.export_trajectory()
    ids = [fr.frame_id for fr in system.frames][: len(poses)]
    est_c = np.stack([_center(P) for P in poses])
    gt_c = np.stack([_center(P) for P in map(ds.gt_pose_c_w, ids)])
    s, R, t = umeyama(est_c, gt_c, True)
    return ids, est_c, gt_c, lambda c: (s * (R @ np.asarray(c).T)).T + t


def _aligned(system, ds) -> tuple:
    """(frame ids, Sim(3)-aligned estimated centres, true centres)."""
    ids, est_c, gt_c, align = _alignment(system, ds)
    return ids, align(est_c), gt_c


def _step_errors(system, ds) -> dict:
    """Frame id -> how far its step from the frame before departs from the
    true step, in units of the median true step."""
    import numpy as np

    ids, aligned, gt_c = _aligned(system, ds)
    d_gt = np.diff(gt_c, axis=0)
    err = (np.linalg.norm(np.diff(aligned, axis=0) - d_gt, axis=1)
           / float(np.median(np.linalg.norm(d_gt, axis=1))))
    return {ids[i + 1]: float(e) for i, e in enumerate(err)}


def _off_truth(system, ds, pred: dict) -> dict:
    """Frame id -> (distance of its predicted centre, of its tracked
    centre) from the true centre after the trajectory's alignment, in
    units of the median true step."""
    import numpy as np

    ids, est_c, gt_c, align = _alignment(system, ds)
    unit = float(np.median(np.linalg.norm(np.diff(gt_c, axis=0), axis=1)))
    row = {f: i for i, f in enumerate(ids)}
    return {f: tuple(float(np.linalg.norm(align(c[None])[0] - gt_c[row[f]])) / unit
                     for c in (_center(P), est_c[row[f]]))
            for f, P in pred.items() if f in row}


def _error_profile(system, ds, span: int = 20) -> str:
    """Largest aligned position error per ``span`` frames (% of extent),
    the five worst frame-to-frame steps and the keyframes' frame ids."""
    import numpy as np

    _, aligned, gt_c = _aligned(system, ds)
    err = 100.0 * np.linalg.norm(aligned - gt_c, axis=1) / float(
        np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    steps = _step_errors(system, ds)
    by_span = [round(float(err[i:i + span].max()), 2) for i in range(0, len(err), span)]
    worst = [(f, round(e, 2)) for f, e in sorted(steps.items(), key=lambda x: -x[1])[:5]]
    kfs = sorted(kf.frame_id for kf in system.kfs.values())
    return f"error by {span} frames {by_span} | worst steps {worst} | KFs at frames {kfs}"


def _trace_decisions(system, lo: int, hi: int) -> tuple:
    """Record, per tracked frame lo..hi-1, what its keyframe decision saw
    (rows) and the world pose of its constant-velocity prediction (pred)."""
    import inspect

    import numpy as np

    from ldso_tpu_torch import frame_step
    from ldso_tpu_torch.math import lie

    process, track_single, rows, pred = system._process_tracked, system._track_single, [], {}
    sig = inspect.signature(process)

    def traced_track(fid, *a, **k):
        if lo <= fid < hi:
            snap = system._snapshot()
            system._reexpress_carries(snap)
            T_l, T_p = system._T_last_rel, system._T_prelast_rel
            T_cv = lie.se3_mul(lie.se3_mul(T_l, lie.se3_inverse(T_p)), T_l)
            pred[fid] = T_cv.cpu().numpy().astype(np.float64) @ snap.T_ref_np
        return track_single(fid, *a, **k)

    def traced(*a, **k):
        arg = sig.bind(*a, **k).arguments
        fid, diag = arg["fid"], arg["diag"]
        version = arg.get("ref_version")
        version = system._ref_version if version is None else version
        newest = system._ref_version
        delta = float(diag[frame_step.DIAG_KF_DELTA])
        eff = system._effective_delta(fid, delta, version)
        st = process(*a, **k)
        if lo <= fid < hi:
            rows.append(dict(fid=fid, ref=system.kfs[arg["ref_kf_id"]].frame_id,
                             version=version, newest=newest, delta=delta, eff=eff,
                             rmse=float(diag[frame_step.DIAG_RMSE0]),
                             kf=bool(st.get("need_kf"))))
        return st

    system._process_tracked, system._track_single = traced, traced_track
    return rows, pred


def _dump_tracking(system, fid_dump: int, path: str):
    """Write what frame ``fid_dump``'s fused step was given (frame, ref,
    prediction pair, affine seed, intrinsics, exposure) and its diag to
    ``path``; returns the function that undoes the hook."""
    import numpy as np

    from ldso_tpu_torch import convert, frame_step

    fused_step, track_single, cur = frame_step.fused_step, system._track_single, {}

    def tracking(fid, *a, **k):
        cur["fid"] = fid
        return track_single(fid, *a, **k)

    def fused(img, ref, T_last, T_prelast, ab0, *rest):
        out = fused_step(img, ref, T_last, T_prelast, ab0, *rest)
        if cur.get("fid") == fid_dump:
            flat = {}
            for f, v in convert.to_numpy(ref).items():
                if isinstance(v, tuple):
                    flat.update({f"ref_{f}_{lvl}": a for lvl, a in enumerate(v)})
                else:
                    flat[f"ref_{f}"] = v
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            np.savez(path, img=img.cpu().numpy(), T_last=T_last.cpu().numpy(),
                     T_prelast=T_prelast.cpu().numpy(), ab0=ab0.cpu().numpy(),
                     intr=rest[-3].cpu().numpy(), exposure=float(rest[-2]),
                     diag=out.diag.cpu().numpy(), **flat)
        return out

    frame_step.fused_step, system._track_single = fused, tracking

    def undo():
        frame_step.fused_step = fused_step

    return undo


def drive(name, cs, cfg, ds, frames, dev, trace=None, dump=None) -> None:
    import torch

    from ldso_tpu_torch.system import FullSystem

    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev, **MODES[name])
    rows, pred = _trace_decisions(system, *trace) if trace else ([], {})
    lc = None
    if name in ("sloop", "aloop"):
        lc, runs, moved = _attach_loop_closing(name, cfg, ds, system)
    undo = (_dump_tracking(system, dump[0], os.path.join(dump[1],
                                                         f"track_{name}_{dump[0]}.npz"))
            if dump is not None else (lambda: None))
    swaps, kf_s = [], []
    update_ref, make_kf = system._update_tracker_ref, system._make_keyframe

    def timed_update_ref(kf):
        update_ref(kf)
        swaps.append(system.frame_count - 1 - kf.frame_id)

    def timed_make_kf(*a, **k):
        t = time.perf_counter()
        make_kf(*a, **k)
        kf_s.append(time.perf_counter() - t)

    system._update_tracker_ref, system._make_keyframe = timed_update_ref, timed_make_kf
    t0 = time.perf_counter()
    try:
        for i, (img, ts, expo) in enumerate(frames):
            if name == "paced":
                wait = t0 + 0.25 * i - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            st = system.add_frame(img, ts, expo)
            if st["status"] == "lost":
                raise RuntimeError(f"{name}: lost at frame {i}: {st}")
            if name == "drain":
                system.finish_mapping()
        system.finish_mapping()
        if lc is not None:
            lc.finish_retrain()
            if name == "aloop":
                lc.finish()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        undo()
        system.shutdown()
        if name == "aloop":
            lc.shutdown()
    lat = system.frame_latency_ms
    extra = _loop_report(cs, system, ds, lc, runs, moved) if lc is not None else ""
    print(f"{ds.n} frames {ds.w}x{ds.h}, {name} (switch interval "
          f"{sys.getswitchinterval():g} s): ATE {cs._ate_pct(system, ds):.4f}% | "
          f"{len(frames) / dt:.3f} frames/s | "
          f"{len(system.kfs)} KFs, kf_suppressed {system.kf_suppressed}, kf_shed_events "
          f"{system.kf_shed_events} | latency median {statistics.median(lat):.1f} ms p95 "
          f"{cs._pctl(lat, 0.95):.1f} ms | KF build median "
          f"{1e3 * statistics.median(kf_s):.0f} ms max {1e3 * max(kf_s):.0f} ms | "
          f"ref-swap lag in frames {swaps[1:]}{extra} | {_error_profile(system, ds)}",
          flush=True)
    steps, off = _step_errors(system, ds), _off_truth(system, ds, pred)
    for r in rows:
        print(f"  frame {r['fid']}: ref KF at frame {r['ref']}, ref version {r['version']} "
              f"(newest {r['newest']}), delta {r['delta']:.3f}, re-evaluated {r['eff']:.3f}, "
              f"coarse RMSE {r['rmse']:.3f}, keyframe {r['kf']}, step error "
              f"{steps.get(r['fid'], float('nan')):.2f}, off the truth: prediction "
              f"{off.get(r['fid'], (float('nan'),) * 2)[0]:.2f} tracked "
              f"{off.get(r['fid'], (float('nan'),) * 2)[1]:.2f}", flush=True)


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from ldso_tpu_torch.config import preset

    dev = torch.device("cuda", 0)
    ds = frames = trace = dump = None
    for word in sys.argv[1:] or ["sync", "drain", "free", "pipe", "batch"]:
        if word.startswith("si="):
            sys.setswitchinterval(float(word[3:]))
        elif word.startswith("dump="):
            fid, out_dir = word[5:].split(",", 1)
            dump = (int(fid), out_dir)
        elif word.startswith("trace="):
            trace = tuple(int(x) for x in word[6:].split(":"))
        elif word.startswith("loop="):
            ds, frames = cs._render_bench(int(word[5:]), cs.LOOP_W, cs.LOOP_H, seed=5,
                                          traj_kind="out_and_back")
        elif word in MODES:
            if ds is None:
                ds, frames = cs._render_bench(cs.N_FRAMES)
            drive(word, cs, preset("default"), ds, frames, dev, trace, dump)
        else:
            raise SystemExit(f"unknown word {word!r}; see the docstring")
    print(cs._card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
