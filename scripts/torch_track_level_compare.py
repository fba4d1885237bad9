#!/usr/bin/env python3
"""Hold the tracker kernel (``csrc/track_level.cu``) against its plain
version (``tracker.track_level_torch``) on the bench sequence's real
tracking inputs, iteration by iteration, on a CUDA card.

    python3 scripts/torch_track_level_compare.py [FRAMES] [DIR]

FRAMES (default ``20,60,100``) are bench frames whose tracking inputs the
sync drive at ``preset("default")`` keeps (``chip_smoke.BenchProbe``). For
each, the five levels are walked as ``track_frame`` chains them, the plain
chain's inputs given to both versions. A level prints its lanes and
points, the largest |dT|, |dab|, relative rmse difference and count
difference over the lanes, and the kernel's iterations. Where |dab| or
|dT| exceeds a thousandth of ``chip_smoke``'s bounds, the level is run
again with the iteration cap set to 1, 2, ... up to its own
(``chip_smoke.cap_walk``, as phase 4b's tie check does), so the first
iteration where the two part shows, with each version's (a, b), rmse and
whether the lane has stopped (the kernel's count below the cap). With
DIR, each such level's inputs and both versions' results per cap go to
``DIR/track_level_f<frame>_L<level>.npz`` (replay them on the CPU, beside
the JAX package, with ``scripts/parity_track_level_replay.py``). The last
line is the card's name and power limit.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _diff(out_k, out_p) -> dict:
    return dict(
        dT=float((out_k[0] - out_p[0]).abs().max()),
        dab=float((out_k[1] - out_p[1]).abs().max()),
        drm=float(((out_k[2] - out_p[2]).abs() / out_p[2].abs().clamp(min=1e-6)).max()),
        dn=max(int((a - b).abs().max()) for a, b in zip(out_k[3:6], out_p[3:6])))


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.kernels import track_level as ktl

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    frames_kept = tuple(int(x) for x in (sys.argv[1] if len(sys.argv) > 1
                                         else "20,60,100").split(","))
    out_dir = sys.argv[2] if len(sys.argv) > 2 else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    card = cs._card_line()
    dev = torch.device("cuda", 0)
    ktl.build()
    n = max(frames_kept) + 1
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        ds, frames = cs._render_bench(cs.N_FRAMES, pool=pool)
    probe = cs.BenchProbe(frames_kept, ())
    run = cs.drive_bench(preset("default"), ds, frames[:n], dev, torch.cuda.synchronize,
                         probe=probe)
    print(f"sync drive over bench frames 0..{n - 1}: ATE {run['ate']:.4f}%, "
          f"{run['n_kf']} KFs | {card}", flush=True)
    for f in frames_kept:
        for l, lv, kw, out_p in cs.track_level_chain(probe.inputs[f]["track"]):
            out_k = ktl.track_level_cuda(*lv, **kw)
            d = _diff(out_k, out_p)
            print(f"frame {f} L{l} {kw['w']}x{kw['h']} {lv[5].shape[0]}x{lv[1].shape[0]}: "
                  f"max|dT| {d['dT']:.3g}, max|dab| {d['dab']:.3g}, rmse rel {d['drm']:.3g}, "
                  f"counts {d['dn']}, kernel iterations {out_k[6].tolist()} of {kw['iters']}",
                  flush=True)
            if d["dab"] <= 1e-3 * cs.TRACK_AB_ATOL and d["dT"] <= 1e-3 * cs.TRACK_T_ATOL:
                continue
            per_cap = []
            for cap, ok_, op_ in cs.cap_walk(lv, kw):
                dc = _diff(ok_, op_)
                lane = int((ok_[1] - op_[1]).abs().amax(-1).argmax())
                per_cap.append(dict(cap=cap, k_T=ok_[0].cpu().numpy(), p_T=op_[0].cpu().numpy(),
                                    k_ab=ok_[1].cpu().numpy(), p_ab=op_[1].cpu().numpy(),
                                    k_rm=ok_[2].cpu().numpy(), p_rm=op_[2].cpu().numpy(),
                                    k_it=ok_[6].cpu().numpy()))
                print(f"  cap {cap}: max|dT| {dc['dT']:.3g}, max|dab| {dc['dab']:.3g}, rmse rel "
                      f"{dc['drm']:.3g}; lane {lane}: ab kernel "
                      f"{ok_[1][lane].tolist()} plain {op_[1][lane].tolist()}, rmse kernel "
                      f"{float(ok_[2][lane])!r} plain {float(op_[2][lane])!r}, kernel "
                      f"iterations {int(ok_[6][lane])}", flush=True)
            if out_dir:
                path = os.path.join(out_dir, f"track_level_f{f}_L{l}.npz")
                np.savez(path, **{k: (t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t))
                                  for k, t in zip(("img3", "uv", "idepth", "color", "valid",
                                                   "T0", "ab0", "intr_l"), lv)},
                         **{f"kw_{k}": np.asarray(v) for k, v in kw.items()},
                         **{f"{k}_{c['cap']}": v for c in per_cap for k, v in c.items()
                            if k != "cap"})
                print(f"  wrote {path}", flush=True)
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
