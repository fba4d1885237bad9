#!/usr/bin/env python3
"""Where the trace and activation kernels' device time goes: the kernels of
``ldso_tpu_torch/csrc/trace.cu`` timed whole and with one phase cut at a
time.

    python3 scripts/torch_trace_phases.py [--old PATH]

Each variant is a copy of the source (with ``csrc/lie.cuh`` beside it)
with a phase cut (written under ``.chip_scratch/trace_phases/``, built with
the same flags, bound in place of the package's library). The trace
(``trace_bank``): ``loads_only`` issues the row's loads, skips the slot
table, passes the CTA's barrier and writes one word a row; ``table_only``
the same with the slot table; ``copy_only`` sends every row down the
invalid row's path (loads, table, the six fields copied through);
``no_sweep_gathers`` scores the sweep's samples without reading the image;
``no_refine`` runs no GN step; ``no_match_gather`` skips the gather at the
match. The activation (``activate_bank``): ``table_only`` makes the slot
rows and each lane's pair entry, writes one word a row and stops; the whole
kernel at iters = 0, 1, 2, 3 gives the cost of an evaluation (one gather
round of every target slot). ``--old PATH`` times an earlier ``trace.cu``
with this checkout's C interface (a copy kept while redesigning) beside
them, as the variant ``old``. A cut variant computes wrong outputs: only its
time is read; the difference between two times is a phase's share, waits
included. Times are device ms (``chip_smoke._device_ms``) on the default-
shape scene of ``tests/test_torch_trace_kernel.py`` (2048 rows, F = 10 of
which four hold the bank's hosts, 640x480, 32 samples). Run from the root
of a checkout, on a machine with a CUDA card.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

_ONE_WORD = ("  __syncthreads();\n  if (row >= p.N) return;                      // a whole warp leaves\n",
             "  __syncthreads();\n  if (row >= p.N) return;\n  if (lane == 0) p.quality_out[row] = "
             "s_slot[kTraceSlot * (hs_in & 3) + kAlpha] + u + v + dmin_in + dmax_in + color[7]"
             " + step_lane[0] + quality_in;\n  return;\n")
TRACE_CUTS = {
    "whole": [],
    "empty": [("  __shared__ float s_slot[kMaxSlots * kTraceSlot];\n",
               "  __shared__ float s_slot[kMaxSlots * kTraceSlot];\n  return;\n")],
    "loads_only": [("  if (tid < p.F)\n    trace_slot(", "  if (false)\n    trace_slot("),
                   _ONE_WORD],
    "table_only": [_ONE_WORD],
    "copy_only": [("  if (!valid) {\n    if (lane == 0) {\n      p.valid_out[row] = 0;",
                   "  if (true) {\n    if (lane == 0) {\n      p.valid_out[row] = 0;")],
    "no_sweep_gathers": [("sample1(p.img3, p.W, p.H, su[m] + kPat[j][0], sv[m] + kPat[j][1])",
                          "(su[m] + kPat[j][0])")],
    "no_refine": [("  for (int it = 0; it < p.gn_iters; ++it) {\n    float hit[3];",
                   "  for (int it = 0; it < 0; ++it) {\n    float hit[3];")],
    "no_match_gather": [("  float hit[3];\n  sample3(p.img3, p.W, p.H, bu, bv, hit);",
                         "  float hit[3] = {bu, bv, bu};")],
}
ACT_CUTS = {
    "whole": [],
    "empty": [("  __shared__ float s_slot[kMaxSlots * kActSlot];\n",
               "  __shared__ float s_slot[kMaxSlots * kActSlot];\n  return;\n")],
    "table_only": [("  const float fx = p.intr[0], fy = p.intr[1], cx = p.intr[2], cy = p.intr[3];\n"
                    "  const float xh0",
                    "  if (tid == 0) p.idepth_out[row] = T[0] + T[11] + alpha + beta + u + v + color;"
                    "\n  return;\n"
                    "  const float fx = p.intr[0], fy = p.intr[1], cx = p.intr[2], cy = p.intr[3];\n"
                    "  const float xh0")],
}


def _variants(src: str, cuts: dict, out_dir: str, tag: str) -> dict:
    text0 = open(src).read()
    paths = {}
    for name, reps in cuts.items():
        text = text0
        for a, b in reps:
            if text.count(a) != 1:
                raise SystemExit(f"torch_trace_phases.py: cut {tag}/{name} no longer matches "
                                 f"csrc/trace.cu")
            text = text.replace(a, b)
        paths[name] = os.path.join(out_dir, f"trace_{tag}_{name}.cu")
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=None)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_phases.py: needs a CUDA card")
    import chip_smoke as cs
    import test_torch_trace_kernel as t
    from ldso_tpu_torch import frame_step
    from ldso_tpu_torch.kernels import cuda_build
    from ldso_tpu_torch.kernels import trace as ktr

    out_dir = os.path.join(ROOT, ".chip_scratch", "trace_phases")
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(os.path.join(os.path.dirname(ktr.SOURCE), "lie.cuh"), out_dir)
    paths = {**{("trace", k): v for k, v in
                _variants(ktr.SOURCE, TRACE_CUTS, out_dir, "k3").items()},
             **{("activate", k): v for k, v in
                _variants(ktr.SOURCE, ACT_CUTS, out_dir, "k5").items()}}
    if a.old:
        old = _variants(a.old, {"old": []}, out_dir, "prev")["old"]
        paths[("trace", "old")] = paths[("activate", "old")] = old
    unique = sorted(set(paths.values()))
    with concurrent.futures.ThreadPoolExecutor(len(unique)) as ex:
        built = dict(zip(unique, ex.map(lambda p: cuda_build.build(p, extra=ktr.NO_FMAD),
                                        unique)))
    libs = {key: built[path] for key, path in paths.items()}
    card = cs._card_line()
    print(f"ptxas: {cs.ptxas_kernels(cuda_build.ptxas_report(ktr.SOURCE, (), ktr.NO_FMAD))}",
          flush=True)
    dev = torch.device("cuda", 0)
    scene = t._scene("default", 640, 480, 0)
    state = cs._trace_state(t._trace_args(scene, device=dev))
    kw = frame_step._trace_kw(scene["cfg"])
    call = t._act_call(scene, device=dev)
    act_state = cs._act_state(call[0])

    def bind(path):
        lib = ctypes.CDLL(path)
        lib.ldso_trace_bank.argtypes, lib.ldso_trace_bank.restype = ktr.TRACE_ARGTYPES, ctypes.c_int
        lib.ldso_activate_bank.argtypes = ktr.ACTIVATE_ARGTYPES
        lib.ldso_activate_bank.restype = ctypes.c_int
        ktr._lib = lambda lib=lib: lib

    times = []
    for (kernel, name), path in libs.items():
        if kernel != "trace":
            continue
        bind(path)
        times.append(f"{name} {1e3 * cs._device_ms(lambda: ktr.trace_bank_cuda(*state, **kw)):.2f}")
    print(f"trace_bank, default scene ({int(state[1].valid.sum())} valid rows of "
          f"{state[1].valid.numel()}), device us: " + "; ".join(times) + f" | {card}",
          flush=True)
    bind(libs[("activate", "whole")])
    can = ktr.activate_bank_cuda(*act_state, **call[1])["can"]
    times = []
    for (kernel, name), path in libs.items():
        if kernel != "activate":
            continue
        bind(path)
        for iters in ((0, 1, 2, 3) if name in ("whole", "old") else (3,)):
            ms = cs._device_ms(lambda: ktr.activate_bank_cuda(*act_state, iters=iters,
                                                              huber_th=call[1]["huber_th"]))
            times.append(f"{name} iters {iters} {1e3 * ms:.2f}")
    print(f"activate_bank, default scene ({int(can.sum())} candidate rows of {can.numel()}, "
          f"{int(act_state[1].sum())} valid slots of {act_state[1].numel()}), device us: "
          + "; ".join(times) + f" | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
