#!/usr/bin/env python3
"""Time the tracker kernel (``csrc/track_level.cu``) level by level on
bench frames' real tracking inputs, with its clock64() phase breakdown, on
a CUDA card; optionally at other launch shapes, and beside an older
version of the kernel.

    python3 scripts/torch_track_level_phases.py [--frames 20,60,100] [--fine 1x256,2x256]
        [--coarse CxT,...] [--old PATH] [--reps N] [--json PATH]

The sync drive at ``preset("default")`` runs bench frames 0..max(frames)
and keeps each frame's ``track_frame`` arguments
(``chip_smoke.BenchProbe``). Its five levels are walked as ``track_frame``
chains them (``chip_smoke.track_level_chain``, the plain chain's inputs).
At each level, for the launch shape the wrapper takes
(``kernels/track_level.launch_config``) and for each other shape named by
``--coarse`` (levels of many lanes) or ``--fine`` (one lane), as cluster
size x threads a CTA: the device ms of a one-level launch (queued behind a
spin kernel, ``chip_smoke._device_ms``; the shapes timed in turns, forth
then back, each shape's two times averaged), microseconds an iteration
(the ms over the slowest lane's iterations), the largest |dT| to the plain
version, and, from the library built with ``-DTRACK_LEVEL_PHASES``, the
cycles per evaluation of each phase (``PHASE_NAMES``; thread 0 of the
slowest lane's rank-0 CTA). Another shape is tried by handing the wrapper
a different ``launch_config`` for the duration of the call: the kernel
takes any cluster of 1 to 8 CTAs of 32 to 256 threads. Then the device ms
of the frame's two launches (``track_levels_cuda``) at the wrapper's
shapes and at each ``--fine`` shape, in turns, and the device kernels of
one ``track_frame`` call (torch.profiler).

``--old PATH`` names a copy of an earlier kernel source, the one-level
kernel from before the level table: its C entry ``ldso_track_level`` (the
one-level arguments, the eight outputs, then a ``phases_out`` pointer
before the stream; its stamps under the same macro). It is timed in turns with
the current kernel (old, new, new, old) at each level. ``ptxas -v`` of
each source is printed. ``--json PATH`` also writes everything there as
one JSON object. The last line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import multiprocessing
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _old_level(lib, lv, kw, phases=None):
    """One launch of the old one-level entry on ``lv`` / ``kw``."""
    import torch

    img3, uv, idepth, color, valid, T0, ab0, intr = lv
    K, N, dev = T0.shape[0], uv.shape[0], T0.device
    f32 = torch.float32
    T = torch.empty((K, 4, 4), dtype=f32, device=dev)
    ab = torch.empty((K, 2), dtype=f32, device=dev)
    rmse = torch.empty((K,), dtype=f32, device=dev)
    n3 = [torch.empty((K,), dtype=torch.int64, device=dev) for _ in range(3)]
    n_iter = torch.empty((K,), dtype=torch.int32, device=dev)
    n_ok_sum = torch.empty((K,), dtype=torch.int64, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = lib.ldso_track_level(
        img3.data_ptr(), kw["h"], kw["w"], uv.data_ptr(), idepth.data_ptr(), color.data_ptr(),
        valid.data_ptr(), N, T0.data_ptr(), ab0.data_ptr(), intr.data_ptr(), K, kw["iters"],
        kw["cutoff"], kw["huber_th"], kw["lam0"], kw["lam_success"], kw["lam_fail"],
        kw["step_eps"], T.data_ptr(), ab.data_ptr(), rmse.data_ptr(), n3[0].data_ptr(),
        n3[1].data_ptr(), n3[2].data_ptr(), n_iter.data_ptr(), n_ok_sum.data_ptr(),
        None if phases is None else phases.data_ptr(), stream)
    if err:
        raise RuntimeError(f"old kernel launch failed: cudaError {err}")
    return T, ab, rmse, *n3, n_iter, n_ok_sum


def _bind_old(path: str, phases: bool):
    from ldso_tpu_torch.kernels import cuda_build, track_level as ktl

    lib = cuda_build.load(path, ktl.PHASES if phases else ())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldso_track_level.argtypes = [p, i, i, p, p, p, p, i, p, p, p, i, i, f, f, f, f, f, f,
                                     p, p, p, p, p, p, p, p, p, p]
    lib.ldso_track_level.restype = i
    return lib


def _shapes(text: str) -> list:
    """'1x256,2x256' -> [(1, 256), (2, 256)]."""
    return [tuple(int(x) for x in s.split("x")) for s in text.split(",") if s]


@contextlib.contextmanager
def _launch_shapes(coarse, fine):
    """Within the block the wrapper launches many lanes at ``coarse`` and
    one lane at ``fine`` (cluster size, threads a CTA)."""
    from ldso_tpu_torch.kernels import track_level as ktl

    orig = ktl.launch_config
    ktl.launch_config = lambda lanes: coarse if lanes > 1 else fine
    try:
        yield
    finally:
        ktl.launch_config = orig


def _in_turns(timers: dict) -> dict:
    """Each timer run forth then back over the dict's order; name -> the
    mean of its two times."""
    order = list(timers) + list(reversed(timers))
    runs = {}
    for name in order:
        runs.setdefault(name, []).append(timers[name]())
    return {name: sum(t) / len(t) for name, t in runs.items()}


def _level_report(cs, ktl, a, args, old, old_ph, dev_ms, card) -> list:
    """Every level of one frame at the wrapper's shape, the other shapes
    and (``old``) the old kernel."""
    import torch

    sync = torch.cuda.synchronize
    dev = args[2].device
    levels = []
    for l, lv, kw, out_p in cs.track_level_chain(args):
        K = lv[5].shape[0]
        main = ktl.launch_config(K)
        shapes = [main] + [s for s in (a.coarse if K > 1 else a.fine) if s != main]
        rec = dict(level=l, lanes=K, points=lv[1].shape[0], cap=kw["iters"], shapes={})

        def one_level(shape, phases=False):
            with _launch_shapes(shape, shape):
                return ktl.track_level_cuda(*lv, **kw, phases=phases)

        timers = {}
        for shape in shapes:
            out = one_level(shape)
            ph = one_level(shape, True)[8]
            sync()
            rec["shapes"][shape] = dict(n_iter_max=int(out[6].max()),
                                        dT=float((out[0] - out_p[0]).abs().max()),
                                        phases=cs.track_phase_row(ph, out[6]))
            timers[f"{shape[0]}x{shape[1]}"] = \
                lambda shape=shape: dev_ms(lambda: one_level(shape))
        if old is not None:
            ph_old = torch.zeros((K, 8), dtype=torch.int64, device=dev)
            out_old = _old_level(old, lv, kw)
            _old_level(old_ph, lv, kw, ph_old)
            sync()
            rec["old"] = dict(n_iter_max=int(out_old[6].max()),
                              dT=float((out_old[0] - out_p[0]).abs().max()),
                              phases=cs.track_phase_row(ph_old, out_old[6]))
            timers = {"old": lambda: dev_ms(lambda: _old_level(old, lv, kw)), **timers}
        ms = _in_turns(timers)
        rows = [(f"{c}x{t}" + (" (wrapper's)" if (c, t) == main else ""), rec["shapes"][(c, t)],
                 ms[f"{c}x{t}"]) for c, t in shapes]
        if old is not None:
            rows.insert(0, ("old", rec["old"], ms["old"]))
        for who, r, t in rows:
            r["ms"] = t
            r["us_per_iteration"] = 1e3 * t / max(r["n_iter_max"], 1)
            phs = r["phases"]
            print(f"L{l} {kw['w']}x{kw['h']} {K}x{rec['points']} cap {kw['iters']} | {who}: "
                  f"{t:.4f} ms, {r['n_iter_max']} iterations, "
                  f"{r['us_per_iteration']:.2f} us an iteration, max|dT| to plain "
                  f"{r['dT']:.3g}; cycles an evaluation: " + ", ".join(
                      f"{n} {phs[n]:.0f}" for n in cs._phase_keys(phs))
                  + f"; {phs['cycles_per_iteration']:.0f} cycles an iteration "
                    f"({phs['evaluations']} evaluations) | {card}", flush=True)
        rec["shapes"] = {f"{c}x{t}": v for (c, t), v in rec["shapes"].items()}
        levels.append(rec)
    return levels


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", default="60")
    ap.add_argument("--coarse", default="")
    ap.add_argument("--fine", default="")
    ap.add_argument("--old", default=None)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--json", default=None)
    a = ap.parse_args()
    a.coarse, a.fine = _shapes(a.coarse), _shapes(a.fine)
    frames = [int(f) for f in a.frames.split(",")]
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ldso_tpu_torch import tracker
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.kernels import cuda_build, track_level as ktl

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = cs._card_line()
    dev = torch.device("cuda", 0)
    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        jobs = [pool.submit(ktl.build), pool.submit(ktl.build, True),
                pool.submit(cuda_build.ptxas_report, ktl.SOURCE)]
        if a.old:
            jobs += [pool.submit(cuda_build.build, a.old),
                     pool.submit(cuda_build.build, a.old, ktl.PHASES),
                     pool.submit(cuda_build.ptxas_report, a.old)]
        done = [j.result() for j in jobs]
    report = {"card": card, "frames": frames, "ptxas": {"new": done[2]}}
    print(f"ptxas (new): {done[2].strip()}", flush=True)
    old = old_ph = None
    if a.old:
        report["ptxas"]["old"] = done[5]
        print(f"ptxas (old): {done[5].strip()}", flush=True)
        old, old_ph = _bind_old(a.old, False), _bind_old(a.old, True)

    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as renders:
        ds, bench = cs._render_bench(cs.N_FRAMES, pool=renders)
    probe = cs.BenchProbe(frames, ())
    run = cs.drive_bench(preset("default"), ds, bench[:max(frames) + 1], dev,
                         torch.cuda.synchronize, probe=probe)
    print(f"sync drive over bench frames 0..{max(frames)}: ATE {run['ate']:.4f}%, "
          f"{run['n_kf']} KFs | {card}", flush=True)

    def dev_ms(fn):
        return cs._device_ms(fn, reps=a.reps)

    main_shapes = (ktl.launch_config(2), ktl.launch_config(1))
    report["per_frame"] = {}
    for f in frames:
        args = probe.inputs[f]["track"]
        print(f"-- bench frame {f}", flush=True)
        rep = report["per_frame"][f] = dict(
            levels=_level_report(cs, ktl, a, args, old, old_ph, dev_ms, card))

        def two_launches(fine):
            with _launch_shapes(main_shapes[0], fine):
                return dev_ms(lambda: cs.fused_levels(args))

        ms = _in_turns({f"{c}x{t}": lambda s=(c, t): two_launches(s)
                        for c, t in [main_shapes[1]] + [s for s in a.fine
                                                         if s != main_shapes[1]]})
        rep["frame_two_launches_ms"] = ms
        for fine, t in ms.items():
            print(f"frame {f}, two launches, coarse {main_shapes[0][0]}x{main_shapes[0][1]}, "
                  f"fine {fine}: {t:.4f} ms device | {card}", flush=True)
        if old is not None:
            rep["frame_old_ms"] = sum(r["old"]["ms"] for r in rep["levels"])
            print(f"frame {f}, the old kernel's five launches: {rep['frame_old_ms']:.4f} ms "
                  f"device (sum of the levels) | {card}", flush=True)
        n_k, ms_k = cs._device_events(lambda: tracker.track_frame(*args))
        rep["track_frame_kernels"], rep["track_frame_device_ms"] = n_k, ms_k
        print(f"frame {f}, one track_frame call: {n_k} device kernels / copies, {ms_k:.3f} ms "
              f"device (torch.profiler) | {card}", flush=True)
    if a.json:
        with open(a.json, "w") as fh:
            json.dump(report, fh, indent=1)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
