#!/usr/bin/env python3
"""The BA linearization kernel (``ldso_tpu_torch/csrc/ba.cu``) on the main
path's real inputs, and ``run_ba``'s time split by what it runs.

    python3 scripts/torch_ba_compare.py [--parent DIR] [--rounds N] [--no-replay]

Each drive runs in a process of its own: the sync ``FullSystem`` at
``preset("default")`` over the 120-frame 640x480 bench sequence, as
``chip_smoke.py`` phase 4 does, with this checkout's
``chip_smoke.BenchProbe``: bench frames 40..59 under torch.profiler, whose
labels split ``run_ba``'s host time into the assembly, the pair tables
made in torch (``precompute_pairs``: made there by a parent whose kernel
reads them from the host; this checkout's kernel makes them itself), the
damped solve, the step, the state deltas, the host syncs, the copies and
the rest (``chip_smoke.ba_split``), with the hand kernel's device ms an
evaluation. The package driven is
the one of the drive's root, so a ``--parent DIR`` (an unpacked ``git
archive`` of an earlier commit, in a directory the repository ignores) is
measured with the same instruments; the drives then alternate parent, this checkout,
this checkout, parent, ``--rounds`` times, so that drift of the host hits
both alike. Without ``--parent`` this checkout is driven ``--rounds``
times. One JSON line per drive, then a summary.

Unless ``--no-replay``, a last drive of this checkout keeps the arguments
of the first two ``run_ba`` calls after bench frame 20 and of one
``marginalize_points`` call that folds, and holds the kernel against the
plain version on them (``chip_smoke.check_ba`` in both modes and for
``energy_only``, ``chip_smoke.check_run_ba`` for a whole ``run_ba``, each
with its tolerances and tie rule; a check that fails is printed, not
raised), with the kernel's device ms beside its bound and the plain
version's ms, and the device kernels of one ``run_ba`` call of each
version. Run from the root of a checkout, on a machine with a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch_pairs


def drive(root: str) -> dict:
    """One phase-4 drive of the package at ``root``."""
    cs, run, probe = torch_pairs.bench_drive(
        root, lambda cs: cs.BenchProbe((), cs.TRACK_PROFILE), "torch_ba_compare.py")
    prof = probe.summary()
    kf = max(prof["keyframe"]["calls"], 1)
    return dict(fps=run["fps"], ate=run["ate"], n_kf=run["n_kf"],
                tracked=run["n_tracked"], wall_ms=prof["wall_ms"],
                kernels_per_frame=prof["launches_per_frame"], busy=prof["busy"],
                keyframe_host_ms=prof["keyframe"]["host_ms"] * prof["frames"] / kf,
                keyframe_device_ms=prof["keyframe"]["device_ms"] * prof["frames"] / kf,
                run_ba=prof["ba_split"], hand_kernels_ms_per_frame=prof["kernels"])


def replay() -> None:
    """A drive of this checkout that keeps run_ba's and marginalize_points'
    arguments, then the kernel against the plain version on them."""
    sys.path.insert(0, torch_pairs.ROOT)
    import torch

    cs = torch_pairs.chip_smoke()
    from ldso_tpu_torch.ba import solve
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.kernels import ba as kba
    from ldso_tpu_torch.kernels import cuda_build

    card = cs._card_line()
    torch_pairs.build_all()
    print(f"ptxas: {cs.ptxas_kernels(cuda_build.ptxas_report(kba.SOURCE, (), kba.NO_FMAD))}",
          flush=True)
    ds, frames = torch_pairs.render(cs, cs.N_FRAMES)
    probe = cs.BenchProbe((), ())
    kba.reset_launches()
    with cs.count_ba() as evals:
        run = cs.drive_bench(preset("default"), ds, frames, torch.device("cuda", 0),
                             torch.cuda.synchronize, probe=probe)
    print(f"drive: ATE {run['ate']:.4f}%, {run['n_kf']} KFs, {run['fps']:.3f} frames/s; BA "
          f"kernel launches {kba.LAUNCHES} for {evals[0]} evaluations ({kba.PER_EVALUATION} "
          f"each) | {card}", flush=True)

    def attempt(name, fn):
        try:
            rec = fn()
        except RuntimeError as e:
            print(f"{name}: FAILED {e}", flush=True)
            return None
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in rec.items()) + f" | {card}",
              flush=True)
        return rec

    for j, (args, kw) in enumerate(probe.ba_calls):
        win, cfg = args[0], args[3]
        for mode in ("active", "fej", "energy"):
            attempt(f"run_ba {j + 1} window, mode {mode}",
                    lambda: cs.check_ba(f"run_ba {j + 1}", win, cfg, mode, time_it=j == 0))
        attempt(f"whole run_ba {j + 1}", lambda: cs.check_run_ba(f"run_ba {j + 1}", args, kw))
    for args, kw in probe.marg_calls:
        attempt("marginalize_points window, mode fej",
                lambda: cs.check_ba("marginalize_points", cs.marg_window(args), args[4], "fej",
                                    time_it=True))
    if probe.ba_calls:
        args, kw = probe.ba_calls[0]
        n_k, ms_k = cs._device_events(lambda: solve.run_ba(*cs._clone(args), **kw))
        with cs.plain_ba():
            n_p, ms_p = cs._device_events(lambda: solve.run_ba(*cs._clone(args), **kw))
        print(f"one run_ba call (run_ba 1): {n_k} device kernels / copies, {ms_k:.3f} ms "
              f"device; plain {n_p}, {ms_p:.3f} ms (torch.profiler) | {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--no-replay", action="store_true")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(drive(a.one)), flush=True)
        return 0
    runs = torch_pairs.in_pairs(__file__, a.parent, a.rounds)
    for name, rs in torch_pairs.by_root(runs, a.parent):
        parts = ("ba_assemble", "ba_precompute", "ba_solve_core", "ba_apply_step",
                 "ba_state_delta", "syncs", "copies", "rest")
        print(f"{name}: run_ba host ms a call " + ", ".join(
                  f"{r['run_ba']['host_ms']:.2f}" for r in rs)
              + f" (median {statistics.median(r['run_ba']['host_ms'] for r in rs):.2f}); "
              + "device ms a call (torch ops + hand kernel) " + ", ".join(
                  f"{r['run_ba']['device_ms']:.3f} + {r['run_ba']['kernel_device_ms']:.3f}"
                  for r in rs)
              + "; the hand kernel's device ms an evaluation " + ", ".join(
                  f"{r['run_ba']['kernel_device_ms'] / max(r['run_ba']['assemble_calls'], 1):.4f}"
                  for r in rs)
              + "; split a call (median): " + ", ".join(
                  f"{p} {statistics.median(r['run_ba'][p] for r in rs):.2f}" for p in parts)
              + f", assemble calls a run_ba "
                f"{statistics.median(r['run_ba']['assemble_calls'] for r in rs):.2f}"
              + "; keyframe path host ms a keyframe " + ", ".join(
                  f"{r['keyframe_host_ms']:.2f}" for r in rs)
              + "; tracked frames/s " + ", ".join(f"{r['fps']:.3f}" for r in rs)
              + "; ATE " + ", ".join(f"{r['ate']:.4f}%" for r in rs)
              + "; KFs " + ", ".join(str(r["n_kf"]) for r in rs), flush=True)
    if not a.no_replay:
        replay()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
