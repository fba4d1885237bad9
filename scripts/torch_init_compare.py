#!/usr/bin/env python3
"""The monocular bootstrap's time on the card, whole, a frame and a level.

    python3 scripts/torch_init_compare.py [--parent DIR] [--rounds N]

Each drive runs, in a process of its own, the sync ``FullSystem`` at
``preset("default")`` of one checkout's package from its first frame to
the frame that initializes, on the 640x480 bench sequence (seed 3,
forward_arc, as phase 4 of ``chip_smoke.py``) and on the 320x240 loop
sequence (seed 5, out_and_back, as phase 5), every frame ending in
``torch.cuda.synchronize()``; each ``init2f.init_level`` call is timed on
the host clock between two synchronizations (a sync more a level than the
drive itself has). It prints one JSON line a drive: frames to initialize,
the bootstrap's seconds (first ``add_frame`` to initialized), its seconds a
frame (the first frame's point selection and neighbour graph first), and
the ms of each level summed over the tracked bootstrap frames (``L4`` ..
``L0``). The first frame
a process tracks pays the first use of the kernel's library and of torch's
ops, as a drive's first bootstrap does.

With ``--parent DIR`` (an unpacked ``git archive`` of an earlier commit, in
a directory the repository ignores) the drives alternate the parent, this
checkout, this checkout, the parent, ``--rounds`` times (``torch_pairs.py``),
then a summary per root; without it, this checkout ``--rounds`` times. Run
from the root of a checkout, on a machine with a CUDA card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import torch_pairs

BOOT_FRAMES = 12        # frames rendered a sequence: the bench sequence initializes on its 7th


def _drive(cfg, ds, frames, dev, sync) -> dict:
    """One bootstrap of the package on the path: a FullSystem fed until it
    initializes, ``sync()`` ending each frame and around each level."""
    from ldso_tpu_torch import init2f
    from ldso_tpu_torch.system import FullSystem

    levels, plain = {}, init2f.init_level

    def timed(*args, **kw):
        sync()
        t = time.perf_counter()
        out = plain(*args, **kw)
        sync()
        key = f"L{kw['level']}"
        levels[key] = levels.get(key, 0.0) + 1e3 * (time.perf_counter() - t)
        return out

    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev)
    init2f.init_level = timed
    t_frames, status = [], None
    try:
        for img, ts, expo in frames:
            t = time.perf_counter()
            status = system.add_frame(img, ts, expo)["status"]
            sync()
            t_frames.append(time.perf_counter() - t)
            if status == "initialized":
                break
    finally:
        init2f.init_level = plain
        system.shutdown()
    if status != "initialized":
        raise SystemExit(f"no initialization in {len(frames)} frames")
    return dict(n_init=len(t_frames), boot_s=sum(t_frames), frames_s=t_frames,
                levels_ms=levels)


def drive(root: str) -> dict:
    """Both sequences' bootstraps with the package at ``root``."""
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_init_compare.py: needs a CUDA card")
    cs = torch_pairs.chip_smoke()
    from ldso_tpu_torch.config import preset

    torch_pairs.build_all()
    seqs = {"bench": (cs.N_FRAMES, cs.W, cs.H, 3, "forward_arc"),
            "loop": (cs.LOOP_FRAMES, cs.LOOP_W, cs.LOOP_H, 5, "out_and_back")}
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = {k: [pool.submit(cs._render_frames, *v, lo, min(lo + 3, BOOT_FRAMES))
                     for lo in range(0, BOOT_FRAMES, 3)] for k, v in seqs.items()}
        frames = {k: [f for p in ps for f in p.result()] for k, ps in parts.items()}
    dev = torch.device("cuda", 0)
    return {k: _drive(preset("default"), cs._sequence(*seqs[k]), frames[k], dev,
                      torch.cuda.synchronize) for k in seqs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(drive(a.one)), flush=True)
        return 0
    runs = torch_pairs.in_pairs(__file__, a.parent, a.rounds)
    for name, rs in torch_pairs.by_root(runs, a.parent):
        for seq in ("bench", "loop"):
            boot = [r[seq]["boot_s"] for r in rs]
            per = [s for r in rs for s in r[seq]["frames_s"][1:]]
            lv = {k: statistics.median(r[seq]["levels_ms"][k] / max(r[seq]["n_init"] - 1, 1)
                                       for r in rs) for k in rs[0][seq]["levels_ms"]}
            first = [r[seq]["frames_s"][0] for r in rs]
            print(f"{name}, {seq}: frames to initialize {[r[seq]['n_init'] for r in rs]}; "
                  f"bootstrap s " + ", ".join(f"{b:.3f}" for b in boot)
                  + f" (median {statistics.median(boot):.3f}); the first frame s "
                  + ", ".join(f"{b:.3f}" for b in first) + "; a tracked bootstrap frame s "
                  f"median {statistics.median(per):.4f}, min {min(per):.4f}, max {max(per):.4f}; "
                  f"ms a tracked frame by level (median over drives) "
                  + ", ".join(f"{k} {v:.2f}" for k, v in sorted(lv.items())), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
