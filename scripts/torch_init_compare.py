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
``L0``), and the first frame's parts (``_drive``). The first frame
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


def _timed(fn, sync, into: list):
    """``fn`` with each call's host-clock ms (between two synchronizations)
    appended to ``into``."""
    def timed(*args, **kw):
        sync()
        t = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        into.append(1e3 * (time.perf_counter() - t))
        return out
    return timed


class _TimedTree:
    """scipy's cKDTree, its build and each query timed into ``into``."""

    def __init__(self, tree_cls, into: list):
        self.tree_cls, self.into = tree_cls, into

    def __call__(self, pts):
        t = time.perf_counter()
        tree = self.tree_cls(pts)
        self.into.append(1e3 * (time.perf_counter() - t))
        into = self.into

        class Tree:
            def query(self, *args, **kw):
                t = time.perf_counter()
                out = tree.query(*args, **kw)
                into.append(1e3 * (time.perf_counter() - t))
                return out
        return Tree()


def _drive(cfg, ds, frames, dev, sync) -> dict:
    """One bootstrap of the package on the path: a FullSystem fed until it
    initializes, ``sync()`` ending each frame and around each level. The
    first frame is split into its parts: ``set_first``'s point selection
    (``select.select_pixels``), the colours of each level (``bilinear``),
    the neighbour graph (scipy's ``cKDTree``, build and query) and the rest
    of ``set_first``; the first ``init_level`` call of the process (the
    first K6 launch, the library's load included) is kept apart."""
    import scipy.spatial

    from ldso_tpu_torch import init2f, select
    from ldso_tpu_torch.system import FullSystem

    levels, plain = {}, init2f.init_level
    first_call = []

    def timed(*args, **kw):
        sync()
        t = time.perf_counter()
        out = plain(*args, **kw)
        sync()
        ms = 1e3 * (time.perf_counter() - t)
        if not first_call:
            first_call.append(ms)
        key = f"L{kw['level']}"
        levels[key] = levels.get(key, 0.0) + ms
        return out

    parts = dict(select=[], colours=[], graph=[], set_first=[])
    orig = (init2f.CoarseInitializer.set_first, select.select_pixels, init2f.bilinear,
            scipy.spatial.cKDTree)

    def set_first(init, pyr, gsq):
        select.select_pixels = _timed(orig[1], sync, parts["select"])
        init2f.bilinear = _timed(orig[2], sync, parts["colours"])
        scipy.spatial.cKDTree = _TimedTree(orig[3], parts["graph"])
        try:
            return _timed(orig[0], sync, parts["set_first"])(init, pyr, gsq)
        finally:
            select.select_pixels, init2f.bilinear, scipy.spatial.cKDTree = orig[1:]

    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device=dev)
    init2f.init_level = timed
    init2f.CoarseInitializer.set_first = set_first
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
        init2f.CoarseInitializer.set_first = orig[0]
        system.shutdown()
    if status != "initialized":
        raise SystemExit(f"no initialization in {len(frames)} frames")
    split = dict(select_ms=sum(parts["select"]), colours_ms=parts["colours"],
                 graph_ms=sum(parts["graph"]), set_first_ms=sum(parts["set_first"]),
                 first_k6_ms=first_call[0] if first_call else None)
    split["set_first_rest_ms"] = (split["set_first_ms"] - split["select_ms"]
                                  - sum(split["colours_ms"]) - split["graph_ms"])
    split["frame_rest_ms"] = 1e3 * t_frames[0] - split["set_first_ms"]
    return dict(n_init=len(t_frames), boot_s=sum(t_frames), frames_s=t_frames,
                levels_ms=levels, first_frame=split)


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
            for r in rs:
                ff = r[seq].get("first_frame")
                if ff is None:
                    continue
                print(f"{name}, {seq}, the first frame's parts (host ms, each ending in a "
                      f"synchronize): select_pixels {ff['select_ms']:.2f}, the colours by level "
                      + " / ".join(f"{x:.2f}" for x in ff["colours_ms"])
                      + f", the cKDTree graph {ff['graph_ms']:.2f}, the rest of set_first "
                      f"{ff['set_first_rest_ms']:.2f} (set_first {ff['set_first_ms']:.2f}), the "
                      f"rest of the frame {ff['frame_rest_ms']:.2f}; the first K6 launch (the "
                      f"next frame's first level, the library's load included) "
                      f"{ff['first_k6_ms']:.2f}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
