#!/usr/bin/env python3
"""The trace and activation kernels (``ldso_tpu_torch/csrc/trace.cu``) on
the main path's real inputs.

Drives the sync ``FullSystem`` at ``preset("default")`` over the first
``--frames`` bench frames (640x480, as ``chip_smoke.py`` phase 4 does),
keeps ``frame_step._trace_core``'s arguments on the ``--capture`` frames
and the arguments of the first two activations after frame 20
(``chip_smoke.BenchProbe``), then holds each build of the two kernels
against the plain versions with ``chip_smoke.check_trace`` /
``check_activate`` (their tolerances and tie rule; a check that fails is
printed, not raised) and times each (device ms, queued behind a spin
kernel), beside the plain versions' ms and the bounds. The ``ptxas -v``
report of the source is printed first. It also counts the
device kernels of one whole ``fused_step`` and of one activation call,
kernel path against plain path. Run from the root of a checkout, on a
machine with a CUDA card:

    python3 scripts/torch_trace_compare.py [--frames 41] [--capture 20,30,40]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _try(fn):
    try:
        return fn(), None
    except RuntimeError as e:
        return None, str(e)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=41)
    ap.add_argument("--capture", default="20,30,40")
    a = ap.parse_args()
    capture = tuple(int(c) for c in a.capture.split(","))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_compare.py: needs a CUDA card")
    from ldso_tpu_torch import frame_step
    from ldso_tpu_torch import trace as trace_mod
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.kernels import cuda_build, pallas_pyramid, track_level
    from ldso_tpu_torch.kernels import trace as ktr

    card = cs._card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool, \
            concurrent.futures.ThreadPoolExecutor(max_workers=3) as builds:
        done = [builds.submit(f) for f in (pallas_pyramid.build, track_level.build, ktr.build)]
        # the first frames of the 120-frame bench sequence
        parts = [pool.submit(cs._render_frames, cs.N_FRAMES, cs.W, cs.H, 3, "forward_arc", lo,
                             min(lo + 6, a.frames)) for lo in range(0, a.frames, 6)]
        frames = [f for p in parts for f in p.result()]
        ds = cs._sequence(cs.N_FRAMES, cs.W, cs.H, 3, "forward_arc")
        libs = [d.result() for d in done]
    print(f"built {', '.join(os.path.relpath(p, ROOT) for p in libs)}; frames rendered; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rep = cs.ptxas_kernels(cuda_build.ptxas_report(ktr.SOURCE, (), ktr.NO_FMAD))
    print(f"ptxas: {rep}", flush=True)

    probe = cs.BenchProbe(capture, ())
    ktr.reset_launches()
    with cs.count_keyframes() as made:
        run = _try(lambda: cs.drive_bench(preset("default"), ds, frames, dev,
                                          torch.cuda.synchronize, probe=probe))
    print(f"drive of {a.frames} bench frames: {run[1] or 'ok'}; trace launches "
          f"{ktr.LAUNCHES_TRACE}, activation launches {ktr.LAUNCHES_ACTIVATE}, keyframes "
          f"built {made[0]} | {card}", flush=True)

    for i in capture:
        if "trace" not in probe.inputs.get(i, {}):
            print(f"bench frame {i}: no trace inputs kept", flush=True)
            continue
        rec, err = _try(lambda: cs.check_trace(f"bench frame {i}", probe.inputs[i]["trace"],
                                               time_it=True))
        print(f"trace bench frame {i}: "
              + (err if err else ", ".join(f"{k} {v}" for k, v in rec.items()))
              + f" | {card}", flush=True)
    for j, call in enumerate(probe.activations):
        rec, err = _try(lambda: cs.check_activate(f"activation {j + 1}", call, time_it=True))
        print(f"activate keyframe {j + 1} after frame {cs.ACT_AFTER}: "
              + (err if err else ", ".join(f"{k} {v}" for k, v in rec.items()))
              + f" | {card}", flush=True)

    if "step" in probe.inputs.get(capture[0], {}):
        step = probe.inputs[capture[0]]["step"]
        n_k, ms_k = cs._device_events(lambda: frame_step.fused_step(*step))
        with cs.plain_trace():
            n_p, ms_p = cs._device_events(lambda: frame_step.fused_step(*step))
        print(f"one fused_step (bench frame {capture[0]}): {n_k} device kernels / copies, "
              f"{ms_k:.3f} ms device; with the plain trace {n_p}, {ms_p:.3f} ms | {card}",
              flush=True)
    if probe.activations:
        args, kw = probe.activations[0]
        n_k, ms_k = cs._device_events(lambda: trace_mod.activate_candidates_device(*args, **kw))
        with cs.plain_trace():
            n_p, ms_p = cs._device_events(
                lambda: trace_mod.activate_candidates_device(*args, **kw))
        print(f"one activate_candidates_device call: {n_k} device kernels / copies, "
              f"{ms_k:.3f} ms device; plain {n_p}, {ms_p:.3f} ms | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
