#!/usr/bin/env python3
"""Phase 4 of ``chip_smoke.py`` alone, for one or two checkouts in turns, on
a CUDA card: the host and device time of ``tracker.track_frame`` per frame,
the frame's device kernels, the tracked frames/s, and the frames' wall time
split by the keyframe decision, so that a change of the keyframe schedule
can be told from a change of the code.

    python3 scripts/torch_tracker_host_time.py [--parent DIR] [--rounds N]

Each drive runs in a process of its own, from the root of its checkout:
the sync drive at ``preset("default")`` over the 120-frame bench sequence,
bench frames 40..59 under torch.profiler (``chip_smoke.BenchProbe``, whose
labels split host and device time by stage). With ``--parent DIR`` (an
unpacked ``git archive`` of an earlier commit) the drives alternate
parent, this checkout, this checkout, parent, ``--rounds`` times, so that
drift of the host hits both alike. Per drive: the frames that made a
keyframe, the median wall ms of the other tracked frames (from frame
``chip_smoke.N_WARM``, the profiled frames left out; each ends in a
synchronize) and the mean of the keyframe frames. One JSON line per drive,
then a summary and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def drive(root: str) -> dict:
    """One phase-4 drive with the ``chip_smoke.py`` of ``root``."""
    sys.path.insert(0, root)
    import concurrent.futures
    import multiprocessing

    import torch

    import chip_smoke as cs
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.kernels import pallas_pyramid, track_level

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    pallas_pyramid.build()
    track_level.build()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        ds, frames = cs._render_bench(cs.N_FRAMES, pool=pool)
    from ldso_tpu_torch.system import FullSystem

    # each frame's wall time (add_frame to the drive's synchronize) and
    # whether it made a keyframe
    times, kf, t0 = [], [], [0.0]
    add_frame = FullSystem.add_frame

    def timed_add_frame(self, *a, **kw):
        t0[0] = time.perf_counter()
        st = add_frame(self, *a, **kw)
        kf.append(bool(st.get("need_kf", False)))
        return st

    def timed_sync():
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0[0]))

    FullSystem.add_frame = timed_add_frame
    track_level.reset_launches()
    probe = cs.BenchProbe((), cs.TRACK_PROFILE)
    run = cs.drive_bench(preset("default"), ds, frames, torch.device("cuda", 0), timed_sync,
                         probe=probe)
    prof = probe.summary()
    rated = [i for i in range(cs.N_WARM, len(times)) if i not in cs.TRACK_PROFILE]
    plain = [times[i] for i in rated if not kf[i]]
    kf_ms = [times[i] for i in rated if kf[i]]
    return dict(root=root, fps=run["fps"], ate=run["ate"], n_kf=run["n_kf"],
                tracked=run["n_tracked"], track_launches=track_level.LAUNCHES,
                wall_ms=prof["wall_ms"], kernels_per_frame=prof["launches_per_frame"],
                busy=prof["busy"], tracker_host_ms=prof["tracker"]["host_ms"],
                tracker_device_ms=prof["tracker"]["device_ms"],
                kf_frames=[i for i, k in enumerate(kf) if k],
                other_frame_ms=statistics.median(plain),
                kf_frame_ms=statistics.mean(kf_ms) if kf_ms else None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(drive(a.one)), flush=True)
        return 0
    roots = [ROOT] if a.parent is None else (
        [os.path.abspath(a.parent), ROOT, ROOT, os.path.abspath(a.parent)] * a.rounds)
    runs = []
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             cwd=root, capture_output=True, text=True, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for name, root in (("parent", a.parent and os.path.abspath(a.parent)), ("this", ROOT)):
        rs = [r for r in runs if r["root"] == root]
        if not rs:
            continue
        print(f"{name}: tracker host ms a frame "
              + ", ".join(f"{r['tracker_host_ms']:.3f}" for r in rs)
              + f" (median {statistics.median(r['tracker_host_ms'] for r in rs):.3f}); "
              + "frames/s " + ", ".join(f"{r['fps']:.3f}" for r in rs)
              + "; device kernels a frame " + ", ".join(f"{r['kernels_per_frame']:.1f}"
                                                       for r in rs)
              + "; ATE " + ", ".join(f"{r['ate']:.4f}%" for r in rs)
              + "; median ms of a frame that made no keyframe " + ", ".join(
                  f"{r['other_frame_ms']:.3f}" for r in rs)
              + f" (median {statistics.median(r['other_frame_ms'] for r in rs):.3f})"
              + "; mean ms of a keyframe frame " + ", ".join(
                  f"{r['kf_frame_ms']:.3f}" for r in rs if r["kf_frame_ms"] is not None)
              + f"; keyframe schedules {sorted({tuple(r['kf_frames']) for r in rs})}",
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
