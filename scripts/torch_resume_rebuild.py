#!/usr/bin/env python3
"""How far a resumed run parts from the uninterrupted one, by what the
checkpoint holds of the port's own state.

    python3 scripts/torch_resume_rebuild.py [--device cuda] [--preset default]
        [--frames 120] [--width 640] [--height 480] [--save-at 60]

Writes the TUM-layout fixture (``scripts/torch_tum_fixture.py``) to a
temporary directory, reads it through ``TumMonoDataset``, runs A over all
frames with a checkpoint after frame ``save-at - 1``, then resumes from
that checkpoint three times:

  exact    the file as ``save_checkpoint`` wrote it (``port_*`` state kept);
  ladder   the ``port`` key dropped, as in a file the JAX package wrote, so
           the state is rebuilt on load; then only the activation ladder
           (``_min_act_dist``, ``_n_active_cache``) put back by hand;
  rebuilt  the ``port`` key dropped and nothing put back.

Prints, per variant, the largest position difference to run A over all
frames and the keyframe counts, and last one JSON object with the gaps.
It asserts nothing: ``chip_smoke.py`` holds ``exact`` to its bound.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--preset", default="default")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--save-at", type=int, default=60)
    a = p.parse_args(argv)

    import torch
    import torch_tum_fixture

    from ldso_tpu_torch.config import preset
    from ldso_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from ldso_tpu_torch.io.datasets import TumMonoDataset
    from ldso_tpu_torch.system import FullSystem

    dev = torch.device(a.device)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = preset(a.preset)
    tmp = tempfile.TemporaryDirectory(prefix="ldso_resume_")
    root, _ = torch_tum_fixture.make_tum_fixture(
        os.path.join(tmp.name, "tum"), n=a.frames, w=a.width, h=a.height, seed=3)
    reader = TumMonoDataset(root, device=dev)
    try:
        frames = [reader.get_image(i) for i in range(reader.num_frames)]
        intr = reader.intrinsics()
    finally:
        reader.close()

    def feed(system, lo, hi):
        for i in range(lo, hi):
            st = system.add_frame(*frames[i])
            if st["status"] == "lost":
                raise RuntimeError(f"lost at frame {i}: {st}")

    def positions(system):
        return system.export_trajectory()[1][:, :3, 3]

    path = os.path.join(tmp.name, "ckpt")
    run_a = FullSystem(cfg, intr, a.width, a.height, device=dev)
    feed(run_a, 0, a.save_at)
    save_checkpoint(run_a, path)
    feed(run_a, a.save_at, len(frames))
    pos_a = positions(run_a)

    with open(path + ".json") as f:
        meta = json.load(f)
    port = meta["port"]
    bare = path + "_bare"
    os.symlink(path + ".npz", bare + ".npz")
    with open(bare + ".json", "w") as f:
        json.dump(dict(meta, port=None), f)

    gaps = {}
    for variant in ("exact", "ladder", "rebuilt"):
        run_b = load_checkpoint(path if variant == "exact" else bare, cfg, device=dev)
        if variant == "ladder":
            run_b._min_act_dist = port["min_act_dist"]
            run_b._n_active_cache = port["n_active"]
        feed(run_b, a.save_at, len(frames))
        gaps[variant] = float(np.abs(pos_a - positions(run_b)).max())
        print(f"{variant}: max |position gap| to the uninterrupted run {gaps[variant]:.3g}; "
              f"KFs {len(run_a.kfs)} / {len(run_b.kfs)} | {card}", flush=True)
    tmp.cleanup()
    print(json.dumps(dict(gaps, preset=a.preset, frames=len(frames), save_at=a.save_at,
                          size=[a.width, a.height], card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
