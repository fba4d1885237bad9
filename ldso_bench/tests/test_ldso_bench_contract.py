"""BENCHMARK.json against the benchmark's contract: names, units, keys,
and every configuration, traffic mix and metric found by its file name."""

import json
import os
import re

import pytest

from ldso_bench.harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.load_benchmark()


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "ldso_bench/run.py"]
    assert BENCH["paths"] == ["ldso_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _one_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_setup_s_is_end_to_end():
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(cell):
    w = cells.find_cell(BENCH, cell)
    conf = cells.load_config(BENCH, w["config"])
    assert conf["name"] == w["config"]
    assert {"width", "height", "preset", "limits", "check"} <= set(conf)
    assert "why" in cells.load_traffic(w["traffic"])
    cfg = cells.port_config(conf)
    assert cfg.shapes.pyr_levels >= 1
    for kind in ("end_to_end", "per_layer"):
        for m in cells.cell_metrics(BENCH, cell, kind):
            assert callable(cells.load_reader(m["name"]).read)
    reported = {m["moves"] for m in cells.cell_metrics(BENCH, cell, "per_layer")}
    assert reported <= {m["name"] for m in cells.cell_metrics(BENCH, cell, "end_to_end")}


def test_config_files_lie_under_paths_and_differ():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("ldso_bench/configs/") for f in files)


def test_port_overrides_reach_the_port_config():
    conf = cells.load_config(BENCH, "dso_fast424")
    cfg = cells.port_config(conf)
    assert cfg.shapes.pyr_levels == 4 and cfg.tracker.max_iterations == (16, 30, 50, 50)
    assert cfg.window.min_kf == 4 and cfg.window.max_kf == 6 and cfg.ba.max_iterations == 4
    assert 424 % (1 << (cfg.shapes.pyr_levels - 1)) == 0


def test_metric_files_match_entries():
    on_disk = {f[:-3] for f in os.listdir(os.path.join(cells.BENCH_DIR, "metrics"))
               if f.endswith(".py")}
    assert {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]} <= on_disk


def test_benchmark_json_is_what_the_harness_reads():
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        assert json.load(f) == BENCH
