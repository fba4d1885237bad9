#!/usr/bin/env python3
"""The trace and activation kernels (``ldso_tpu_torch/csrc/trace.cu``) on
the main path's real inputs, and what the trace costs a frame.

    python3 scripts/torch_trace_compare.py [--parent DIR] [--rounds N] [--no-replay]
                                           [--frames 41] [--capture 20,30,40]

With ``--parent DIR`` (an unpacked ``git archive`` of an earlier commit, in
a directory the repository ignores), first the pairs (``torch_pairs.py``):
drives alternate the parent, this checkout, this checkout, the parent,
``--rounds`` times (0: none), each in a process of its own with the
package of its root and this checkout's ``chip_smoke.BenchProbe``: the sync ``FullSystem`` at ``preset("default")``
over the 120-frame 640x480 bench sequence (phase 4 of ``chip_smoke.py``),
bench frames 40..59 under torch.profiler. Each drive prints one JSON line:
tracked frames/s, ATE, keyframes, ``_trace_core``'s host and device ms a
frame, the activation's host ms a keyframe, the hand kernels' device ms a
frame, the device kernels a frame, and the device kernels of one whole
``fused_step`` (bench frame 60's inputs) and of one activation call (the
first keyframe after frame 20); then a summary per root.

Unless ``--no-replay``, a drive of this checkout over the first
``--frames`` bench frames keeps ``frame_step._trace_core``'s arguments on
the ``--capture`` frames and the arguments of the first two activations
after frame 20, then holds each kernel against its plain version with
``chip_smoke.check_trace`` / ``check_activate`` (their tolerances and tie
rule, the kernels' tables against the torch tables, the activation against
its order's replay; a check that fails is printed, not raised) and times
each (device ms, queued behind a spin kernel) beside the plain version's ms
and the bound. With ``--parent``, the parent's kernels run on the same
inputs (with the torch tables, where the parent's interface takes them),
their outputs held to this checkout's bit for bit, and both timed in turns
(parent, this, this, parent, three times): the parent's kernel alone, and
with its torch tables where it takes them. Run from the root of a checkout,
on a machine with a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import torch_pairs


def drive(root: str) -> dict:
    """One phase-4 drive of the package at ``root``."""
    cs, run, probe = torch_pairs.bench_drive(
        root, lambda cs: cs.BenchProbe((60,), cs.TRACK_PROFILE, act_keep=1),
        "torch_trace_compare.py")
    from ldso_tpu_torch import frame_step
    from ldso_tpu_torch import trace as trace_mod

    prof = probe.summary()
    step = probe.inputs[60]["step"]
    n_step, _ = cs._device_events(lambda: frame_step.fused_step(*step))
    args, kw = probe.activations[0]
    n_act, _ = cs._device_events(lambda: trace_mod.activate_candidates_device(*args, **kw))
    return dict(fps=run["fps"], ate=run["ate"], n_kf=run["n_kf"],
                wall_ms=prof["wall_ms"], kernels_per_frame=prof["launches_per_frame"],
                busy=prof["busy"], trace_host_ms=prof["trace"]["host_ms"],
                trace_device_ms=prof["trace"]["device_ms"],
                activate_host_ms=prof["kf_activate"]["host_ms_call"],
                hand_kernels_ms_per_frame=prof["kernels"], fused_step_kernels=n_step,
                activation_call_kernels=n_act)


def _parent_kernels(parent: str):
    """The parent's ``kernels/trace.py`` (its source, its library), bound
    beside this checkout's."""
    spec = importlib.util.spec_from_file_location(
        "parent_trace_kernels", os.path.join(parent, "ldso_tpu_torch", "kernels", "trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def replay(a) -> None:
    """This checkout's kernels against the plain versions (and the
    parent's kernels) on the main path's inputs."""
    sys.path.insert(0, torch_pairs.ROOT)
    import torch

    cs = torch_pairs.chip_smoke()
    from ldso_tpu_torch import frame_step
    from ldso_tpu_torch import trace as trace_mod
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.kernels import cuda_build
    from ldso_tpu_torch.kernels import trace as ktr

    capture = tuple(int(c) for c in a.capture.split(","))
    card = cs._card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    torch_pairs.build_all()
    ds, frames = torch_pairs.render(cs, a.frames)
    print(f"built and rendered in {time.perf_counter() - t0:.1f} s; ptxas: "
          f"{cs.ptxas_kernels(cuda_build.ptxas_report(ktr.SOURCE, (), ktr.NO_FMAD))}",
          flush=True)
    probe = cs.BenchProbe(capture, ())
    ktr.reset_launches()
    with cs.count_keyframes() as made:
        try:
            cs.drive_bench(preset("default"), ds, frames, dev, torch.cuda.synchronize,
                           probe=probe)
            err = "ok"
        except RuntimeError as e:         # the short drive's ATE is not the point
            err = str(e)
    print(f"drive of {a.frames} bench frames: {err}; trace launches {ktr.LAUNCHES_TRACE}, "
          f"activation launches {ktr.LAUNCHES_ACTIVATE}, keyframes built {made[0]} | {card}",
          flush=True)

    def attempt(name, fn):
        try:
            rec = fn()
        except RuntimeError as e:
            print(f"{name}: FAILED {e}", flush=True)
            return None
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in rec.items()) + f" | {card}",
              flush=True)
        return rec

    old = _parent_kernels(a.parent) if a.parent else None
    for i in capture:
        if "trace" not in probe.inputs.get(i, {}):
            print(f"bench frame {i}: no trace inputs kept", flush=True)
            continue
        args = probe.inputs[i]["trace"]
        attempt(f"trace bench frame {i}", lambda: cs.check_trace(f"bench frame {i}", args,
                                                                 time_it=True))
        if old is not None:
            attempt(f"trace bench frame {i}, parent's kernel",
                    lambda: _against_parent_trace(cs, frame_step, ktr, old, args))
    for j, call in enumerate(probe.activations):
        attempt(f"activate keyframe {j + 1} after frame {cs.ACT_AFTER}",
                lambda: cs.check_activate(f"activation {j + 1}", call, time_it=True))
        if old is not None:
            attempt(f"activate keyframe {j + 1}, parent's kernel",
                    lambda: _against_parent_activate(cs, trace_mod, ktr, old, call))


def _in_turns(cs, fns: dict, rounds: int = 3) -> dict:
    """Device ms of each function, in turns a, b, b, a, ``rounds`` times:
    each one's mean and its readings."""
    names = list(fns)
    ms = {n: [] for n in names}
    for n in (names + names[::-1]) * rounds:
        ms[n].append(cs._device_ms(fns[n]))
    return {n: (sum(v) / len(v), [round(t, 5) for t in v]) for n, v in ms.items()}


def _takes(fn, name: str) -> bool:
    return name in inspect.signature(fn).parameters


def _against_parent_trace(cs, frame_step, ktr, old, args) -> dict:
    """The parent's trace kernel against this checkout's on
    ``_trace_core``'s arguments: every output bit for bit; device ms of
    both in turns, and a parent that takes the torch tables (an earlier
    interface) with its tables too."""
    state, kw = cs._trace_state(args), frame_step._trace_kw(args[-1])
    img3, bank, intr = state[0], state[1], state[-1]
    own_tables = _takes(old.trace_bank_cuda, "T_eval")
    tables = None if own_tables else frame_step.trace_slot_tables(*state[2:8])

    def parent(debug=False):
        if own_tables:
            return old.trace_bank_cuda(*state, debug=debug, **kw)
        return old.trace_bank_cuda(img3, bank, *tables, intr, debug=debug, **kw)

    a, b = parent(True), ktr.trace_bank_cuda(*state, debug=True, **kw)
    differ = [f for f, x, y in zip(ktr.TraceBankOut._fields, a, b) if not cs._bits_equal(x, y)]
    ms = _in_turns(cs, {"parent": parent, "this": lambda: ktr.trace_bank_cuda(*state, **kw)})
    rec = dict(fields_differ=differ or "none", ms_this=ms["this"][0],
               ms_parent=ms["parent"][0], readings_this=ms["this"][1],
               readings_parent=ms["parent"][1])
    if not own_tables:
        rec["ms_parent_with_torch_tables"] = cs._device_ms(
            lambda: old.trace_bank_cuda(img3, bank, *frame_step.trace_slot_tables(*state[2:8]),
                                        intr, **kw))
    return rec


def _against_parent_activate(cs, trace_mod, ktr, old, call) -> dict:
    """The parent's activation kernel against this checkout's: every
    output bit for bit; device ms of both in turns, and a parent that takes
    the torch tables (an earlier interface) with its tables too."""
    args, kw = call
    state = cs._act_state(args)
    win_images, frame_valid, T_all, x, expo, bank, intr, min_q = state
    own_tables = _takes(old.activate_bank_cuda, "T_all")
    tables = None if own_tables else trace_mod.activation_slot_tables(T_all, x, expo)

    def parent():
        if own_tables:
            return old.activate_bank_cuda(*state, **kw)
        return old.activate_bank_cuda(win_images, frame_valid, *tables, bank, intr, min_q, **kw)

    a, b = parent(), ktr.activate_bank_cuda(*state, **kw)
    differ = [k for k in a if not cs._bits_equal(a[k], b[k])]
    ms = _in_turns(cs, {"parent": parent, "this": lambda: ktr.activate_bank_cuda(*state, **kw)})
    rec = dict(outputs_differ=differ or "none", ms_this=ms["this"][0],
               ms_parent=ms["parent"][0], readings_this=ms["this"][1],
               readings_parent=ms["parent"][1])
    if not own_tables:
        rec["ms_parent_with_torch_tables"] = cs._device_ms(
            lambda: old.activate_bank_cuda(win_images, frame_valid,
                                           *trace_mod.activation_slot_tables(T_all, x, expo),
                                           bank, intr, min_q, **kw))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--no-replay", action="store_true")
    ap.add_argument("--frames", type=int, default=41)
    ap.add_argument("--capture", default="20,30,40")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(drive(a.one)), flush=True)
        return 0
    if a.parent:
        a.parent = os.path.abspath(a.parent)
        runs = torch_pairs.in_pairs(__file__, a.parent, a.rounds)
        for name, rs in torch_pairs.by_root(runs, a.parent):

            def col(key, fmt=".3f"):
                vals = [r[key] for r in rs]
                return (", ".join(f"{v:{fmt}}" for v in vals)
                        + f" (median {statistics.median(vals):{fmt.replace('d', 'g')}})")

            print(f"{name}: _trace_core host ms a frame {col('trace_host_ms')}; device ms a "
                  f"frame {col('trace_device_ms', '.4f')}; kf_activate host ms a keyframe "
                  f"{col('activate_host_ms')}; tracked frames/s {col('fps')}; ATE "
                  f"{col('ate', '.4f')} %; KFs {col('n_kf', 'd')}; device kernels a frame "
                  f"{col('kernels_per_frame', '.1f')}; one fused_step "
                  f"{col('fused_step_kernels', 'd')} device kernels; one activation call "
                  f"{col('activation_call_kernels', 'd')}", flush=True)
    if not a.no_replay:
        replay(a)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
