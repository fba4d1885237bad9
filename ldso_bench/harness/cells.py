"""Find a cell's configuration, traffic mix and per-layer metrics by name.

``BENCHMARK.json`` names them; the files are ``configs/<file>`` (the
configuration entry's ``file``), ``traffic/<traffic>.json`` and
``metrics/<metric>.py``. A later cell or metric is new files and entries
here; nothing in this module changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics this workload
    reports: those whose ``workloads`` list it, or that have none."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    """The module ``metrics/<name>.py``: ``read(ctx)`` returns the metric's
    value, or None where the run gave it nothing to read; optional
    ``SPANS`` {label: ["module:attr", ...]} are host spans it needs and
    ``CAPTURE`` {key: "module:attr"} calls it needs kept in the traced
    slice."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ldso_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _replace(obj, overrides: dict):
    """``dataclasses.replace`` down a tree of frozen dataclasses: a dict
    value overrides the fields of a nested dataclass, a list becomes a
    tuple."""
    kw = {}
    for key, val in overrides.items():
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur):
            kw[key] = _replace(cur, val)
        else:
            kw[key] = tuple(val) if isinstance(val, list) else val
    return dataclasses.replace(obj, **kw)


def port_config(conf: dict):
    """The port's ``LdsoConfig``: ``config.preset(conf["preset"])`` with the
    configuration file's ``port_overrides``."""
    from ldso_tpu_torch import config

    return _replace(config.preset(conf["preset"]), conf.get("port_overrides", {}))


def intrinsics(conf: dict) -> tuple:
    """Pinhole (fx, fy, cx, cy): f = focal_factor * width, centre at the
    middle of the pixel grid, as the synthetic sequences make it."""
    w, h = conf["width"], conf["height"]
    f = conf["focal_factor"] * w
    return (f, f, w / 2 - 0.5, h / 2 - 0.5)
