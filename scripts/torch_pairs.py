"""What the compare scripts (``torch_ba_compare.py``,
``torch_trace_compare.py``) share: a phase-4 bench drive of the package of
a given checkout, and such drives of a parent checkout and this one in
turns, each in a process of its own.

A script drives one root when it is called as ``SCRIPT --one ROOT`` and
prints that drive's JSON object as its last line; ``in_pairs`` calls it so
for parent, this checkout, this checkout, parent, ``rounds`` times (or this
checkout ``rounds`` times without a parent), so that drift of the host hits
both alike. The package driven is the one of the drive's root, measured
with this checkout's ``chip_smoke.py``.
"""

from __future__ import annotations

import concurrent.futures
import importlib
import importlib.util
import json
import multiprocessing
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    """This checkout's chip_smoke.py, whatever checkout's package is on
    the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def build_all() -> None:
    """Build the hand kernels that the package on the path has."""
    for name in ("pallas_pyramid", "track_level", "trace", "ba", "init_level"):
        try:
            mod = importlib.import_module(f"ldso_tpu_torch.kernels.{name}")
        except ImportError:
            continue
        mod.build()


def render(cs, n: int):
    """(dataset, frames): the 120-frame 640x480 bench sequence of phase 4
    and its first ``n`` frames, rendered in chunks on worker processes."""
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = [pool.submit(cs._render_frames, cs.N_FRAMES, cs.W, cs.H, 3, "forward_arc", lo,
                             min(lo + 6, n)) for lo in range(0, n, 6)]
        frames = [f for p in parts for f in p.result()]
    return cs._sequence(cs.N_FRAMES, cs.W, cs.H, 3, "forward_arc"), frames


def bench_drive(root: str, probe_of, script: str) -> tuple:
    """The sync ``FullSystem`` at ``preset("default")`` over the bench
    sequence with the package at ``root``, as phase 4 of chip_smoke.py
    drives it, watched by ``probe_of(cs)`` (a ``chip_smoke.BenchProbe``).
    Returns (chip_smoke, the drive's record, the probe)."""
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{script}: needs a CUDA card")
    cs = chip_smoke()
    from ldso_tpu_torch.config import preset

    build_all()
    ds, frames = render(cs, cs.N_FRAMES)
    probe = probe_of(cs)
    run = cs.drive_bench(preset("default"), ds, frames, torch.device("cuda", 0),
                         torch.cuda.synchronize, probe=probe)
    return cs, run, probe


def in_pairs(script: str, parent, rounds: int) -> list:
    """Drives of ``parent`` and this checkout in turns by ``script --one``
    (each printed as it ends); their JSON objects, each with its ``root``."""
    parent = parent and os.path.abspath(parent)
    roots = [ROOT] * rounds if parent is None else [parent, ROOT, ROOT, parent] * rounds
    runs = []
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(script), "--one", root],
                             cwd=root, capture_output=True, text=True)
        if out.returncode:
            raise SystemExit(f"drive of {root} failed:\n{out.stdout[-4000:]}"
                             f"{out.stderr[-8000:]}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        runs[-1]["root"] = root
        print(json.dumps(runs[-1]), flush=True)
    return runs


def by_root(runs: list, parent) -> list:
    """[(name, that root's runs)] for the parent and this checkout, those
    that were driven."""
    parent = parent and os.path.abspath(parent)
    named = (("parent", parent), ("this", ROOT))
    return [(name, [r for r in runs if r["root"] == root]) for name, root in named
            if root is not None and any(r["root"] == root for r in runs)]
