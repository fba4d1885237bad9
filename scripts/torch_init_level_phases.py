#!/usr/bin/env python3
"""Time the bootstrap kernel (``csrc/init_level.cu``, K6) level by level on
the bench bootstrap's real inputs, with its clock64() phase breakdown, on a
CUDA card; optionally beside an older source of the kernel.

    python3 scripts/torch_init_level_phases.py [--old PATH] [--reps N] [--json PATH]

The sync ``FullSystem`` at ``preset("default")`` runs the 640x480 bench
sequence (seed 3, forward_arc, as phase 4 of ``chip_smoke.py``) from its
first frame to the frame that initializes, and keeps the arguments of every
``init2f.init_level`` call (``chip_smoke.BenchProbe``). Each tracked
bootstrap frame's five levels are walked as ``CoarseInitializer.track``
chains them, on the plain chain's inputs (``chip_smoke.init_level_chain``).
At each level: the device ms of one launch, queued behind a spin kernel
(``chip_smoke._device_ms``); microseconds an iteration; the bound
(``chip_smoke.init_level_bound_ms``); and, from the library built with
``-DINIT_LEVEL_PHASES``, the cycles an iteration of each phase
(``PHASE_NAMES``; thread 0 of the rank-0 CTA).

``--old PATH`` names an older source of ``ldso_init_level``, with the
headers it includes beside it: for example the kernel's first, one-CTA
version (``git show 4a51534:ldso_tpu_torch/csrc/init_level.cu``, with
``csrc/lie.cuh``), whose entry has no ``phases_out`` and is called without
it, or a copy of it that takes ``phases_out`` and stamps its phases under
the same macro. It is built beside this one, timed in turns with it (old,
new, new, old: each one's two times averaged) at each level, its phases
printed if its entry takes ``phases_out``, and its outputs (and ladders)
compared bit for bit with the new kernel's. A frame's device ms is the sum
of its five levels'. ``ptxas -v`` of each build is printed. ``--json PATH``
also writes everything there as one JSON object. The last line is the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOT_FRAMES = 12        # frames rendered: the bench sequence initializes on its 7th


def bootstrap_levels(cs, cfg, ds, frames, dev) -> list:
    """The kept ``init_level`` calls of each tracked bootstrap frame (a list
    of (args, keywords) a frame, coarsest level first) of a sync
    ``FullSystem`` fed ``frames`` until it initializes."""
    from ldso_tpu_torch.system import FullSystem

    probe = cs.BenchProbe((), ())
    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev)
    status = None
    try:
        for i, (img, ts, expo) in enumerate(frames):
            probe.before(i)
            status = system.add_frame(img, ts, expo)["status"]
            probe.after(i)
            if status == "initialized":
                break
    finally:
        system.shutdown()
    if status != "initialized":
        raise SystemExit(f"no initialization in {len(frames)} frames")
    first = max(j for j, rec in enumerate(probe.boot) if "gsq" in rec)
    return [rec["levels"] for rec in probe.boot[first + 1:]]


def takes_phases(src: str) -> bool:
    """Whether the ``ldso_init_level`` of the source at ``src`` takes
    ``phases_out``."""
    entry = re.search(r'extern "C" int ldso_init_level\((.*?)\)\s*\{', open(src).read(), re.S)
    return "phases_out" in entry.group(1)


class WithoutPhases:
    """The library of a source whose entry has no ``phases_out`` (before
    ``stream``), called with the wrapper's arguments less that one."""

    def __init__(self, lib):
        self.lib = lib

    def ldso_init_level(self, *args):
        return self.lib.ldso_init_level(*args[:-2], args[-1])


def bind_old(kinit, cuda_build, src: str):
    """(library, instrumented library or None) of the older source."""
    import ctypes

    if takes_phases(src):
        return kinit.bind(src), kinit.bind(src, True)
    lib = cuda_build.load(src)
    lib.ldso_init_level.argtypes = kinit.ARGTYPES[:-2] + kinit.ARGTYPES[-1:]
    lib.ldso_init_level.restype = ctypes.c_int
    return WithoutPhases(lib), None


def _in_turns(timers: dict) -> dict:
    """Each timer run forth then back over the dict's order; name -> the
    mean of its two times."""
    order = list(timers) + list(reversed(timers))
    runs = {}
    for name in order:
        runs.setdefault(name, []).append(timers[name]())
    return {name: sum(t) / len(t) for name, t in runs.items()}


def phase_row(ph) -> dict:
    """An instrumented launch's cycles (``PHASE_NAMES``) as cycles an
    iteration of each phase, the start's and the launch's whole cycles."""
    from ldso_tpu_torch.kernels import init_level as kinit

    row = dict(zip(kinit.PHASE_NAMES, ph.cpu().tolist()))
    it = max(int(row["iterations"]), 1)
    out = {n: row[n] / it for n in kinit.PHASE_NAMES[1:-2]}
    out.update(start=row["start"], level=row["level"], iterations=int(row["iterations"]),
               cycles_per_iteration=(row["level"] - row["start"]) / it)
    return out


def _equal(a, b) -> bool:
    """Two launches' outputs bit for bit (every tensor field but phases)."""
    import torch

    return all(torch.equal(x, y) for f, x, y in zip(a._fields, a, b)
               if f != "phases" and x is not None)


def level_report(cs, kinit, args, kw, out_p, old, reps, card) -> dict:
    """One level: this build and the old one."""
    import torch

    n = args[1].shape[0]
    outs, rows, timers = {}, {}, {}

    def launch(lib=None, phases=False):
        return kinit.init_level_cuda(*args, **kw, ladder=True, phases=phases, lib=lib)

    if old is not None:
        outs["old"] = launch(old[0])
        if old[1] is not None:
            rows["old"] = phase_row(launch(old[1], phases=True).phases)
        timers["old"] = lambda: cs._device_ms(lambda: launch(old[0]), n=5, reps=reps)
    outs["new"] = launch()
    rows["new"] = phase_row(launch(phases=True).phases)
    timers["new"] = lambda: cs._device_ms(lambda: launch(), n=5, reps=reps)
    torch.cuda.synchronize()
    ms = _in_turns(timers)
    new = outs["new"]
    bound, by, _, _ = cs.init_level_bound_ms(args, kw, new)
    rec = dict(level=kw["level"], iters=kw["iters"], points=n, w=args[0].shape[1],
               h=args[0].shape[0], snapped=bool(kw["snapped"]),
               launch=kinit.launch_config(n), bound_ms=bound, bound_by=by, ms=ms, phases=rows,
               dT_plain=float((new.T - out_p.T).abs().max()), bitwise={})
    if old is not None:
        rec["bitwise"]["old"] = _equal(outs["old"], new)
    it = max(kw["iters"], 1)
    for who in timers:
        ph = rows.get(who)
        print(f"L{kw['level']} {rec['w']}x{rec['h']} {n} points {kw['iters']} it "
              f"{'snapped' if kw['snapped'] else 'before the snap'} | {who}: {ms[who]:.4f} ms, "
              f"{1e3 * ms[who] / it:.2f} us an iteration (bound {bound:.6f} ms by {by})"
              + ("" if ph is None else "; cycles an iteration " + ", ".join(
                  f"{name} {ph[name]:.0f}" for name in kinit.PHASE_NAMES[1:-2])
                 + f"; {ph['cycles_per_iteration']:.0f} in all, start {ph['start']:.0f}")
              + ("" if who == "new" else f"; bit for bit the new kernel's: "
                 f"{rec['bitwise'][who]}") + f" | {card}", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json", default=None)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.kernels import cuda_build, init_level as kinit

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = cs._card_line()
    dev = torch.device("cuda", 0)
    builds = [(kinit.SOURCE, ()), (kinit.SOURCE, kinit.PHASES)]
    if a.old:
        builds += [(a.old, ())] + ([(a.old, kinit.PHASES)] if takes_phases(a.old) else [])
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        jobs = [pool.submit(cuda_build.build, src, d) for src, d in builds]
        reports = [pool.submit(cuda_build.ptxas_report, src, d) for src, d in builds]
        for j in jobs:
            j.result()
        reports = [r.result() for r in reports]
    report = {"card": card, "ptxas": {}}
    for (src, d), text in zip(builds, reports):
        name = ("old" if src == a.old else "new") + (" phases" if d else "")
        report["ptxas"][name] = text
        print(f"ptxas ({name}): " + " ".join(
            ln.strip() for ln in text.splitlines() if "init_level" in ln or "Used" in ln
            or "spill" in ln), flush=True)
    old = bind_old(kinit, cuda_build, a.old) if a.old else None
    print(f"launch: a cluster of {kinit.CLUSTER} CTAs x {kinit.THREADS // kinit.CLUSTER} threads",
          flush=True)

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as renders:
        parts = [renders.submit(cs._render_frames, cs.N_FRAMES, cs.W, cs.H, 3, "forward_arc",
                                lo, min(lo + 3, BOOT_FRAMES)) for lo in range(0, BOOT_FRAMES, 3)]
        frames = [f for p in parts for f in p.result()]
    ds = cs._sequence(cs.N_FRAMES, cs.W, cs.H, 3, "forward_arc")
    boot = bootstrap_levels(cs, preset("default"), ds, frames, dev)
    print(f"bench bootstrap: {len(boot)} tracked bootstrap frames, "
          f"{sum(len(f) for f in boot)} levels | {card}", flush=True)
    report["frames"] = []
    for j, levels in enumerate(boot):
        print(f"-- bootstrap frame {j + 1} of {len(boot)}", flush=True)
        recs = [level_report(cs, kinit, args, kw, out_p, old, a.reps, card)
                for args, kw, out_p, _ in cs.init_level_chain(levels)]
        whos = list(recs[0]["ms"])
        frame = {who: sum(r["ms"][who] for r in recs) for who in whos}
        iters = sum(r["iters"] for r in recs)
        bound = sum(r["bound_ms"] for r in recs)
        report["frames"].append(dict(levels=recs, ms=frame, bound_ms=bound, iters=iters))
        print(f"bootstrap frame {j + 1}, five launches: " + ", ".join(
            f"{who} {t:.4f} ms ({1e3 * t / iters:.2f} us an iteration, {t / bound:.0f}x the "
            f"bound)" for who, t in frame.items())
            + f"; bound {bound:.6f} ms; bit for bit " + ", ".join(
                f"{who} {all(r['bitwise'][who] for r in recs)}" for who in recs[0]["bitwise"])
            + f" | {card}", flush=True)
    if a.json:
        with open(a.json, "w") as fh:
            json.dump(report, fh, indent=1)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
