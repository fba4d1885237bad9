#!/usr/bin/env python3
"""How far the bootstrap's result moves with float32 rounding, and what the
batched async drive makes of it.

    python3 scripts/torch_init_sensitivity.py [--perturb 0,1,2,3] [--no-async]

First, level by level on every bench bootstrap frame's plain chain (the
inputs of phase 4e, ``chip_smoke.init_level_chain``): the kernel against
the plain version, and the plain version with its idepth0 scaled by 1 +
2^-23 against the plain version, each by ``chip_smoke.compare_init_level``
(max|dT|, the points beyond the idepth and iR bounds, the energy), and
whether the kernel's accept ladder parts from the plain one.

Then the bench sequence's bootstrap (``chip_smoke.py`` phase 4's frames, at
``preset("default")``) runs through ``init2f.CoarseInitializer`` three
ways: the kernel (K6), the plain version in float32 and the plain version
in float64 (``init_level_torch`` on float64 copies of its arguments), each
with the first frame's colours scaled by 1 + k 2^-23 for each k of
``--perturb`` (k = 0: as they are; k = 1: about one ulp). It prints
``chip_smoke.g1_compare``'s numbers between the three at each k (points
good in both, median depth gap, rotation gap, translation cosine, after
``results()``'s scale normalization) and between each one's k and its k =
0. Unless ``--no-async``, each k then drives phase 6 (b) (``async_mapping``,
``pipeline_depth=8``, ``batch_size=4``, free-running over the 120 frames)
with the kernel's and with the plain bootstrap, and prints ATE, whole-drive
frames/s and keyframes (the ATE bound is not applied here). Run from the
root of a checkout, on a machine with a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys

import torch_pairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain64(*args, **kw):
    """``init_level_torch`` in float64, its results back in float32."""
    import torch

    from ldso_tpu_torch import init2f

    out = init2f.init_level_torch(*(a.double() if torch.is_tensor(a) and a.is_floating_point()
                                    else a for a in args), **kw)
    return init2f.InitLevelOut(*(x.float() if x.dtype == torch.float64 else x for x in out))


@contextlib.contextmanager
def _perturbed(k: int):
    """Within the block, ``set_first`` scales the first frame's colours by
    1 + k 2^-23."""
    from ldso_tpu_torch import init2f

    cls = init2f.CoarseInitializer
    set_first = cls.set_first

    def scaled(self, pyr, gsq):
        set_first(self, pyr, gsq)
        self.colors = [c * (1 + k * 2.0 ** -23) for c in self.colors]

    cls.set_first = scaled
    try:
        yield
    finally:
        cls.set_first = set_first


@contextlib.contextmanager
def _levels_by(fn):
    from ldso_tpu_torch import init2f

    kernel = init2f.init_level
    if fn is not None:
        init2f.init_level = fn
    try:
        yield
    finally:
        init2f.init_level = kernel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--perturb", default="0,1,2,3")
    ap.add_argument("--no-async", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_init_sensitivity.py: needs a CUDA card")
    cs = torch_pairs.chip_smoke()
    from ldso_tpu_torch import init2f
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.kernels import init_level as kinit
    from ldso_tpu_torch.kernels.pyramid import build_pyramid_torch

    dev = torch.device("cuda", 0)
    cfg = preset("default")
    ds, frames = torch_pairs.render(cs, cs.N_FRAMES)
    levels = cfg.shapes.pyr_levels
    pyrs = [build_pyramid_torch(torch.as_tensor(f[0], device=dev), levels)[0]
            for f in frames[:12]]
    gsq = [torch.sum(p[..., 1:3] ** 2, dim=-1) for p in pyrs[0]]
    kept, level = [], init2f.init_level

    def keep(*args, **kw):
        kept[-1].append((cs._clone(args), cs._clone(kw)))
        return level(*args, **kw)

    init = init2f.CoarseInitializer(cfg, ds.intrinsics(), dev)
    init.set_first(pyrs[0], gsq)
    with _levels_by(keep):
        for pyr in pyrs[1:]:
            kept.append([])
            if init.track(pyr)["done"]:
                break
    for j, calls in enumerate(kept):
        for args, kw, out_p, lad_p in cs.init_level_chain(calls):
            out_k = kinit.init_level_cuda(*args, **kw, ladder=True)
            one_ulp = list(args)
            one_ulp[6] = args[6] * (1 + 2.0 ** -23)
            out_q = init2f.init_level_torch(*one_ulp, **kw)
            part = cs.ladder_parting(out_k.ladder.cpu(), lad_p.cpu())
            rk, rq = cs.compare_init_level(out_k, out_p), cs.compare_init_level(out_q, out_p)
            print(f"bootstrap frame {j + 1}, L{kw['level']} "
                  f"({'snapped' if kw['snapped'] else 'before the snap'}): kernel max|dT| "
                  f"{rk['e_T']:.3g}, idepth / iR points beyond {rk['n_idepth']} / {rk['n_iR']}, "
                  f"energy rel {rk['e_E']:.3g}, ladders "
                  + ("equal" if part is None else f"part at iteration {part['it']}")
                  + f"; plain at idepth0 one ulp up: max|dT| {rq['e_T']:.3g}, idepth / iR "
                  f"points beyond {rq['n_idepth']} / {rq['n_iR']}, energy rel {rq['e_E']:.3g}",
                  flush=True)
    ks = [int(k) for k in a.perturb.split(",")]
    ways = {"kernel": None, "plain32": init2f.init_level_torch, "plain64": _plain64}
    res = {}
    for k in ks:
        for name, fn in ways.items():
            with _perturbed(k), _levels_by(fn):
                init = init2f.CoarseInitializer(cfg, ds.intrinsics(), dev)
                init.set_first(pyrs[0], gsq)
                for pyr in pyrs[1:]:
                    if init.track(pyr)["done"]:
                        break
                res[name, k] = init.results()
        for x, y in (("kernel", "plain64"), ("plain32", "plain64"), ("kernel", "plain32")):
            g = cs.g1_compare(res[y, k], res[x, k])
            print(f"k {k}: {x} against {y}: both good {g['both']:.4f}, median depth gap "
                  f"{g['idepth']:.3g}, rotation {g['rot']:.3g} rad, translation cos "
                  f"{g['cos']:.6f}", flush=True)
    for name in ways:
        for k in ks[1:]:
            g = cs.g1_compare(res[name, ks[0]], res[name, k])
            print(f"{name}: k {k} against k {ks[0]}: median depth gap {g['idepth']:.3g}, "
                  f"rotation {g['rot']:.3g} rad, translation cos {g['cos']:.6f}", flush=True)
    if not a.no_async:
        for k in ks:
            for name, ctx in (("kernel", contextlib.nullcontext), ("plain", cs.plain_init)):
                with _perturbed(k), ctx():
                    # an infinite sync ATE lifts the drive's ATE bound: the
                    # spread is what is asked for here
                    r = cs.drive_async(cfg, ds, frames, dev, torch.cuda.synchronize,
                                       float(np.inf), batched=True)
                print(f"async + pipeline_depth 8 + batch 4, {name} bootstrap, k {k}: ATE "
                      f"{r['ate']:.4f}%, {r['fps_all']:.3f} frames/s, {r['n_kf']} KFs",
                      flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
