"""The port's span recorder (``ldso_tpu_torch.telemetry``): nesting, self
time, frame ids across threads, nothing recorded while off, the same
outputs on and off, its stamps on torch.profiler's clock, and the
benchmark's readers of it on a tiny CPU cell."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ldso_tpu_torch import telemetry
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.io.synthetic import SyntheticDataset
from ldso_tpu_torch.system import FullSystem

READERS = ["frame_ms", "conductor_self_ms", "device_wait_ms", "predict_ms", "track_ms",
           "trace_ms", "activate_ms", "kf_finish_ms", "seed_select_ms", "ba_solve_ms",
           "ba_accept_pct"]


@pytest.fixture(autouse=True)
def _recorder_off():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()
    torch.set_num_threads(n)


def _by_name(frame):
    out = {}
    for s in frame.spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nesting_parent_self_time_and_frames_across_threads():
    @telemetry.span("leaf")
    def leaf():
        time.sleep(0.002)

    def work(fid):
        with telemetry.span("root", frame=fid):
            with telemetry.span("mid"):
                leaf()
                leaf()
                telemetry.count("n", 2)
            time.sleep(0.003)

    telemetry.enable()
    t = threading.Thread(target=work, args=(7,))
    t.start()
    work(3)
    t.join(timeout=10)
    assert not t.is_alive()
    with telemetry.span("loose"):
        telemetry.count("n")
    telemetry.disable()

    frames, dropped = telemetry.frames()
    assert dropped == 0
    by_id = {f.id: f for f in frames}
    assert set(by_id) == {3, 7, None}
    assert [s.name for s in by_id[None].spans] == ["loose"] and by_id[None].counts == {"n": 1}
    for fid in (3, 7):
        f = by_id[fid]
        spans = _by_name(f)
        assert sorted(spans) == ["leaf", "mid", "root"] and len(spans["leaf"]) == 2
        root, mid = spans["root"][0], spans["mid"][0]
        assert root.parent == -1 and mid.parent == root.seq
        assert all(s.parent == mid.seq for s in spans["leaf"])
        assert len({s.thread for s in f.spans}) == 1
        assert root.start_ns <= mid.start_ns and mid.end_ns <= root.end_ns
        assert f.counts == {"n": 2}
        tot = telemetry.totals([f])
        leaf_ns = sum(s.end_ns - s.start_ns for s in spans["leaf"])
        assert tot["leaf"][0] == 2 and tot["leaf"][1] == tot["leaf"][2] == leaf_ns
        assert tot["mid"][2] == mid.end_ns - mid.start_ns - leaf_ns
        assert tot["root"][2] == (root.end_ns - root.start_ns) - (mid.end_ns - mid.start_ns)
        assert tot["root"][2] >= 2_500_000            # the 3 ms sleep is root's own
    assert {by_id[3].spans[0].thread, by_id[7].spans[0].thread} == {
        threading.get_ident(), t.ident}


def test_ring_counts_frames_it_drops(monkeypatch):
    monkeypatch.setattr(telemetry, "RING_FRAMES", 4)
    telemetry.enable()
    for fid in range(6):
        with telemetry.span("f", frame=fid):
            pass
    frames, dropped = telemetry.frames()
    assert [f.id for f in frames] == [2, 3, 4, 5] and dropped == 2


def test_off_records_nothing_and_opens_no_record_function():
    @telemetry.span("decorated")
    def fn(x):
        return x + 1

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("plain", frame=1):
            assert fn(1) == 2
        telemetry.count("c")
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & {"plain", "decorated"}
    assert telemetry.frames() == ([], 0)


def _drive(n_frames=12, profile_from=None):
    """A tiny sync drive; with ``profile_from``, the frames from that one
    on run under torch.profiler (CPU activity). (system, profiler, the
    profiler's start on the span clock)."""
    ds = SyntheticDataset(w=128, h=96, n=n_frames, traj_kind="forward_arc", seed=0,
                          supersample=1)
    system = FullSystem(preset("tiny"), ds.intrinsics(), ds.w, ds.h, device="cpu")
    prof = t_prof = None
    for i in range(ds.num_frames):
        if i == profile_from:
            prof = profile(activities=[ProfilerActivity.CPU])
            prof.__enter__()
            t_prof = time.perf_counter_ns()
        system.add_frame(*ds.get_image(i))
    if prof is not None:
        prof.__exit__(None, None, None)
    return system, prof, t_prof


def _rows(system, path):
    system.write_metrics(str(path))
    return [json.loads(line) for line in open(path)]


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    """The same drive with the recorder off, then on, its tracked frames
    under torch.profiler (CPU activity): (system off, system on, the
    profiler and its start, frames, rows off, rows on)."""
    tmp = tmp_path_factory.mktemp("telemetry")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        telemetry.disable()
        telemetry.reset()
        off, _, _ = _drive()
        assert telemetry.frames() == ([], 0)
        rows_off = _rows(off, tmp / "off.jsonl")
        telemetry.enable()
        on, prof, t_prof = _drive(profile_from=10)
        telemetry.disable()
        frames = telemetry.frames()
        rows_on = _rows(on, tmp / "on.jsonl")
    finally:
        telemetry.disable()
        telemetry.reset()
        torch.set_num_threads(n)
    return off, on, (prof, t_prof), frames, rows_off, rows_on


def test_recorder_changes_no_output(drives):
    off, on, _, (frames, dropped), rows_off, rows_on = drives
    assert dropped == 0 and len(frames) == 12
    assert len(on.kfs) == len(off.kfs) >= 4             # keyframes built after the bootstrap
    for a, b in zip(off.export_trajectory(), on.export_trajectory()):
        np.testing.assert_array_equal(a, b)
    assert off.metrics == on.metrics
    assert all("ms" not in r and "counts" not in r for r in rows_off)
    assert [{k: v for k, v in r.items() if k not in ("ms", "counts")} for r in rows_on] \
        == rows_off
    # every tracked frame's row carries its spans; a keyframe's its path and BA's counters
    assert all({"add_frame", "fused_step", "track", "trace"} <= set(r["ms"]) for r in rows_on)
    kf_rows = [r for r in rows_on if "kf_id" in r]
    assert kf_rows and all({"kf_path", "activate", "ba", "ba.solve", "kf_finish"}
                           <= set(r["ms"]) for r in kf_rows)
    assert all(r["counts"]["ba.trials"] >= r["counts"]["ba.accepted"] for r in kf_rows)


def test_fused_step_and_kf_path_children(drives):
    _, _, _, (frames, _), _, _ = drives
    tracked = [f for f in frames if "fused_step" in _by_name(f)]
    assert tracked
    for f in tracked:
        spans = _by_name(f)
        (step,) = spans["fused_step"]
        (root,) = spans["add_frame"]
        assert step.parent == root.seq
        kids = {s.name for s in f.spans if s.parent == step.seq}
        assert kids == {"pyramid", "predict", "track", "trace"}
    kf = [f for f in frames if "kf_path" in _by_name(f)]
    for f in kf:
        (path,) = _by_name(f)["kf_path"]
        kids = {s.name for s in f.spans if s.parent == path.seq}
        assert kids == {"activate", "seed_select", "ba", "tracker_ref", "seed_patch",
                        "kf_finish"}
        (ba,) = _by_name(f)["ba"]
        assert {s.name for s in f.spans if s.parent == ba.seq} >= {
            "ba.assemble", "ba.solve", "ba.apply", "wait.ba_gate", "wait.ba_stats"}


def test_stamps_agree_with_the_profilers_record_functions(drives):
    _, _, (prof, t_prof), (frames, _), _, _ = drives
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = {}
    for f in frames:
        for s in f.spans:
            if s.start_ns > t_prof:
                spans.setdefault(s.name, []).append(s)
    assert {"add_frame", "fused_step", "kf_path", "ba", "wait.ba_gate"} <= set(spans)
    gaps = []
    for name, ss in spans.items():
        evs = sorted(events.get(name, []))
        assert len(evs) == len(ss), name               # one record_function a span
        for s, (e0, e1) in zip(sorted(ss, key=lambda s: s.start_ns), evs):
            gaps += [abs(telemetry.to_unix_ns(s.start_ns) - e0),
                     abs(telemetry.to_unix_ns(s.end_ns) - e1)]
    assert float(np.median(gaps)) < 100_000            # 0.1 ms


class _UntilKeyframe:
    """The tiny cell's run arguments, with a window that lasts until the
    recorder has seen a keyframe built in it: the same work on a fast or
    a loaded machine (a window of seconds can end before its first
    keyframe)."""

    workload, trace, device = "tiny.walk", 1, "cpu"

    def __init__(self, seed: int):
        self.seed = seed

    @property
    def seconds(self):
        frames, _ = telemetry.frames()
        done = len(frames) > 200 or any(s.name == "kf_path" for f in frames for s in f.spans)
        return 0.0 if done else 1e9


def test_tiny_cell_reports_the_span_metrics():
    from ldso_bench.harness import cells, main
    from ldso_bench.tests import tiny_cell

    # the readers' helper turns the recorder on when first imported
    sys.modules.pop("ldso_bench.harness.program_spans", None)
    undo = tiny_cell.use_tiny(cells)
    try:
        bench = cells.load_benchmark()
        cell = cells.find_cell(bench, tiny_cell.TINY)
        conf = cells.load_config(bench, cell["config"])
        res = main.drive(_UntilKeyframe(3000000011), bench, cell, conf,
                         cells.load_traffic(cell["traffic"]), torch.device("cpu"),
                         time.perf_counter(), torch)
    finally:
        undo()
        telemetry.disable()
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(m)
    assert m["conductor_self_ms"] >= 0.0 and 0.0 <= m["ba_accept_pct"] <= 100.0
    assert m["frame_ms"] >= m["track_ms"] + m["trace_ms"] + m["predict_ms"]
