#!/usr/bin/env python3
"""Where the BA linearization kernel's device time goes: the kernel of
``ldso_tpu_torch/csrc/ba.cu`` timed whole and with one phase cut at a time.

    python3 scripts/torch_ba_phases.py

Each variant is a copy of the source with an early exit or a skipped block
(written under ``.chip_scratch/ba_phases/``, built with the same flags,
bound in place of the package's library): ``no_final`` stops after the
tiles (no partials written or added), ``no_top`` after the group sums,
``no_owners`` skips the owner threads' partial sums, ``owners_noadd`` runs
them without their adds, ``no_finalize`` skips the per-point outputs,
``no_words`` stops each task after its rows (no butterfly sums),
``no_task`` runs no task, ``prologue_only`` stops after the per-slot
table. A cut variant computes wrong outputs: only its time is read. The
difference between the whole kernel's time and a variant's is that phase's
share, waits included. Times are device ms (``chip_smoke._device_ms``) of
``assemble_cuda`` (mode active) and ``energy_only_cuda`` on default-shape
windows of ``tests/test_torch_ba_kernel.py`` (2048 points, 10 slots,
640x480) with 6 and with 4 valid slots. Run from the root of a checkout,
on a machine with a CUDA card.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

CUTS = {
    "whole": [],
    "no_final": [("  const int w4 = n4 / 4;\n  float4* part4",
                  "  return;\n  const int w4 = n4 / 4;\n  float4* part4")],
    "no_top": [("  if (tid == 0) p.counters[groups] = 0u;\n",
                "  if (tid == 0) p.counters[groups] = 0u;\n  return;\n")],
    "no_owners": [("    if (nonempty) {\n      // kOwn", "    if (false) {\n      // kOwn")],
    "owners_noadd": [("              if ((m >> t) & 1u) v += w[t];",
                      "              if ((m >> t) & 1u) v += 0.f;")],
    "no_finalize": [("    if (!energy_only && warp < NPT && p0 + warp < p.P) {",
                     "    if (false) {")],
    "no_words": [("  const float wd = x[kW] * x[kD];\n  group_words",
                  "  return;\n  const float wd = x[kW] * x[kD];\n  group_words")],
    "no_task": [("      run_task(p, s_slot, s_delta, s_vslot, nvalid, pt, q, lane,",
                 "      if (false) run_task(p, s_slot, s_delta, s_vslot, nvalid, pt, q, lane,")],
    "prologue_only": [("  const int nvalid = s_nvalid;\n  const int QP",
                       "  return;\n  const int nvalid = s_nvalid;\n  const int QP")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_ba_phases.py: needs a CUDA card")
    import chip_smoke as cs
    import test_torch_ba_kernel as t
    from ldso_tpu_torch.kernels import ba as kba
    from ldso_tpu_torch.kernels import cuda_build

    src = open(kba.SOURCE).read()
    out_dir = os.path.join(ROOT, ".chip_scratch", "ba_phases")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, reps in CUTS.items():
        text = src
        for a, b in reps:
            if a not in text:
                raise SystemExit(f"torch_ba_phases.py: cut {name} no longer matches csrc/ba.cu")
            text = text.replace(a, b)
        paths[name] = os.path.join(out_dir, f"ba_{name}.cu")
        with open(paths[name], "w") as f:
            f.write(text)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as ex:
        libs = dict(zip(paths, ex.map(lambda p: cuda_build.build(p, extra=kba.NO_FMAD),
                                      paths.values())))
    card = cs._card_line()
    print(f"ptxas: {cs.ptxas_kernels(cuda_build.ptxas_report(kba.SOURCE, (), kba.NO_FMAD))}",
          flush=True)
    argtypes = kba._lib().ldso_ba_assemble.argtypes
    dev = torch.device("cuda", 0)
    for label, slots in (("6 valid slots", t.SLOTS), ("4 valid slots", (0, 2, 3, 5))):
        win = t._twin(t._window(slots=slots), device=dev)
        times = []
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            lib.ldso_ba_assemble.argtypes, lib.ldso_ba_assemble.restype = argtypes, ctypes.c_int
            kba._lib = lambda lib=lib: lib
            ms_a = cs._device_ms(lambda: kba.assemble_cuda(win, 9.0, 2500.0))
            ms_e = cs._device_ms(lambda: kba.energy_only_cuda(win, 9.0, 2500.0))
            times.append(f"{name} {1e3 * ms_a:.2f} / {1e3 * ms_e:.2f} us")
        print(f"window with {label} (2048 points, {int(win.p_valid.sum())} valid), assemble / "
              f"energy_only device: " + "; ".join(times) + f" | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
