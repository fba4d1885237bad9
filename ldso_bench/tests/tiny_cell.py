"""A tiny cell on the CPU for the harness's own tests: ``preset("tiny")``
at 320x240 under the walk traffic, the plain versions of the kernels, a
window of a few seconds. Run as a module it is one whole run of the
harness (``python -m ldso_bench.tests.tiny_cell --seed 7 --seconds 3``)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

TINY = "tiny.walk"


def tiny_bench(cells) -> tuple:
    """(benchmark, configuration) with the tiny cell added: the 640x480
    configuration's limits and checks, cut to the tiny preset."""
    bench = cells.load_benchmark()
    bench["workloads"].append(dict(name=TINY, config="tiny", traffic="walk", chips=1,
                                   why="the harness's tests"))
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(cells.BENCH_DIR, "configs", "dso_tum640.json")) as f:
        conf = json.load(f)
    conf.update(name="tiny", preset="tiny", width=320, height=240, port_overrides={},
                check={"steps": 2, "keyframes": 1, "evaluations": 2, "init_levels": 1})
    # a window of seconds on the CPU folds no point: no marginalization reading
    conf["limits"] = {k: v for k, v in conf["limits"].items() if not k.startswith("marg")}
    return bench, conf


def use_tiny(cells):
    """Point the harness's loaders at the tiny cell; returns the undo."""
    bench, conf = tiny_bench(cells)
    saved = cells.load_benchmark, cells.load_config
    cells.load_benchmark = lambda root=None: bench
    cells.load_config = lambda b, name, root=None: conf

    def undo():
        cells.load_benchmark, cells.load_config = saved
    return undo


def drive(seed: int, seconds: float, control: bool = False, window_hook=None,
          trace: int = 0) -> dict:
    """One tiny run in this process; the result line as a dict."""
    import torch

    from ldso_bench.harness import cells, main

    undo = use_tiny(cells)
    try:
        bench = cells.load_benchmark()
        cell = cells.find_cell(bench, TINY)
        conf = cells.load_config(bench, cell["config"])
        a = argparse.Namespace(workload=TINY, seed=seed, seconds=seconds, trace=trace,
                               device="cpu")
        return main.drive(a, bench, cell, conf, cells.load_traffic("walk"), torch.device("cpu"),
                          time.perf_counter(), torch, control=control, window_hook=window_hook)
    finally:
        undo()


if __name__ == "__main__":
    t0 = time.perf_counter()
    import torch

    torch.set_num_threads(2)
    from ldso_bench.harness import cells, main

    use_tiny(cells)
    sys.exit(main.run(["--workload", TINY, "--device", "cpu", *sys.argv[1:]], t0))
