"""Readings for the limits of the comparison: the program on many seeds,
the control on some, in one process (the kernels built once).

    python3 ldso_bench/reference/calibrate.py --workload dso640.walk \
        --seeds 11,12,13 --control 3 --seconds 4 [--out calib.jsonl]

Each seed is a whole run of the cell (set-up, a window of ``--seconds``,
the comparison) whose numbers are printed as a JSON line; the first
``--control`` seeds also give the control's readings: the plain reference
in the program's place with its inputs and pyramid in bfloat16
(``harness/check.py``). A limit lies between the largest program reading
and the smallest control reading (``PERF.md``).
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".build", "triton")
sys.path.insert(0, ROOT)


def main(argv) -> int:
    import argparse

    import torch

    from ldso_bench.harness import cells, main as hm

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    bench = cells.load_benchmark()
    cell = cells.find_cell(bench, a.workload)
    conf = cells.load_config(bench, cell["config"])
    traffic = cells.load_traffic(cell["traffic"])
    dev = torch.device("cuda", 0) if a.device == "cuda" else torch.device("cpu")
    out = open(a.out, "a") if a.out else None
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        run = argparse.Namespace(workload=a.workload, seed=seed, seconds=a.seconds, trace=0,
                                 device=a.device)
        t0 = time.perf_counter()
        res = hm.drive(run, bench, cell, conf, traffic, dev, t0, torch,
                       control=i < a.control)
        line = dict(workload=a.workload, seed=seed, correct=res["correct"],
                    frames=res["attempted"], fps=res["metrics"]["frames_per_s"]["value"],
                    program={k: c["value"] for k, c in res["checks"].items()},
                    control=res.get("control"))
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
