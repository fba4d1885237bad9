#!/usr/bin/env python3
"""Drive the port's FullSystem modes over the 640x480 bench sequence on a
CUDA card and print one line per drive.

    python3 scripts/torch_async_modes.py [WORD ...]

Each WORD is a drive, run in the order given on a fresh FullSystem at
``preset("default")`` (120 frames, as ``chip_smoke.py`` renders them):
  sync        synchronous
  drain       async_mapping, finish_mapping() after every frame (must equal
              sync to the last digit)
  free        async_mapping, free-running
  pipe        async_mapping, pipeline_depth=8
  batch       async_mapping, pipeline_depth=8, batch_size=4
  paced       async_mapping, one frame every 0.25 s
  si=SECONDS  not a drive: sets ``sys.setswitchinterval`` for the drives
              after it (how often CPython lets a waiting thread take the
              interpreter lock; default 0.005)
Default: sync drain free pipe batch. A line gives ATE (% of extent),
frames/s over the whole drive (host clock, drain included), keyframes,
suppressed wants, submit-to-pose latency, the wall time of keyframe builds
and, per keyframe, how many frames later its tracker-ref swap landed. The
last line is the card's name and power limit.
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
}


def drive(name, cs, cfg, ds, frames, dev) -> None:
    import torch

    from ldso_tpu_torch.system import FullSystem

    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev, **MODES[name])
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
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        system.shutdown()
    lat = system.frame_latency_ms
    print(f"{name} (switch interval {sys.getswitchinterval():g} s): ATE "
          f"{cs._ate_pct(system, ds):.4f}% | {len(frames) / dt:.3f} frames/s | "
          f"{len(system.kfs)} KFs, kf_suppressed {system.kf_suppressed}, kf_shed_events "
          f"{system.kf_shed_events} | latency median {statistics.median(lat):.1f} ms p95 "
          f"{cs._pctl(lat, 0.95):.1f} ms | KF build median "
          f"{1e3 * statistics.median(kf_s):.0f} ms max {1e3 * max(kf_s):.0f} ms | "
          f"ref-swap lag in frames {swaps[1:]}", flush=True)


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from ldso_tpu_torch.config import preset

    dev = torch.device("cuda", 0)
    ds, frames = cs._render_bench(cs.N_FRAMES)
    for word in sys.argv[1:] or ["sync", "drain", "free", "pipe", "batch"]:
        if word.startswith("si="):
            sys.setswitchinterval(float(word[3:]))
        elif word in MODES:
            drive(word, cs, preset("default"), ds, frames, dev)
        else:
            raise SystemExit(f"unknown word {word!r}; see the docstring")
    print(cs._card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
