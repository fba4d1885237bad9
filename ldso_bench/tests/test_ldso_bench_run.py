"""Whole runs of a tiny cell on the CPU: the result line, the modules a run
loads, the control and planted faults against the comparison's limits."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from ldso_bench.harness import cells
from ldso_bench.tests import tiny_cell

ROOT = cells.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "ldso_tpu"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _limits():
    return tiny_cell.tiny_bench(cells)[1]["limits"]


def test_a_run_prints_its_result_and_loads_no_jax():
    code = ("import runpy, sys; sys.argv = ['tiny', '--seed', '3000000007', '--seconds', '2'];"
            "\ntry:\n    runpy.run_module('ldso_bench.tests.tiny_cell', run_name='__main__')"
            "\nexcept SystemExit as e:\n    rc = e.code"
            "\nprint('MODULES', sorted({m.split('.')[0] for m in sys.modules}))"
            "\nprint('RC', rc)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "RC 0", out.stderr[-3000:]
    mods = set(eval(lines[-2][len("MODULES "):]))
    assert not mods & FORBIDDEN
    assert "ldso_tpu_torch" in mods          # the port's name begins with the JAX package's
    res = json.loads(lines[-3])
    assert res["correct"] is True
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "ldso_bench/run.py", "--workload", "dso640.walk",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_control_fails_the_limits():
    res = tiny_cell.drive(3000000011, 2.0, control=True)
    assert res["correct"] is True
    lim = _limits()
    failed = [k for k, v in res["control"].items() if k in lim and v > lim[k]]
    assert {"pyramid_gap", "track_energy_gap", "trace_rows_parted"} <= set(failed)


def _trace_unchanged():
    from ldso_tpu_torch import frame_step

    orig = frame_step._trace_core
    frame_step._trace_core = lambda img3, bank, *rest: bank
    return lambda: setattr(frame_step, "_trace_core", orig)


def _pose_altered():
    from ldso_tpu_torch import frame_step
    from ldso_tpu_torch.math import lie

    orig = frame_step._track_core

    def altered(*args):
        pyr, gsq, T, ab, diag = orig(*args)
        nudge = lie.se3_exp(torch.tensor([0.0, 0.0, 0.0, 0.0, 0.01, 0.0], dtype=T.dtype))
        T = lie.se3_mul(nudge, T)
        return pyr, gsq, T, ab, torch.cat([diag[:11], T.reshape(-1)])
    frame_step._track_core = altered
    return lambda: setattr(frame_step, "_track_core", orig)


def _ba_unchanged():
    from ldso_tpu_torch.ba import solve

    orig = solve._fixed_scaled_solve
    solve._fixed_scaled_solve = lambda H_f, b_f, *rest: torch.zeros_like(b_f)
    return lambda: setattr(solve, "_fixed_scaled_solve", orig)


def _ba_one_iteration():
    from ldso_tpu_torch.ba import solve

    orig = solve.run_ba

    def capped(win, HM, bM, cfg, **kw):
        return orig(win, HM, bM, cfg.replace(ba=dataclasses.replace(cfg.ba, max_iterations=1)),
                    **kw)
    solve.run_ba = capped
    return lambda: setattr(solve, "run_ba", orig)


def _seeds_halved():
    from ldso_tpu_torch import system

    orig = system._seed_program

    def halved(*args, **kw):
        out = dict(orig(*args, **kw))
        keep = torch.arange(out["sel_valid"].shape[0], device=out["sel_valid"].device) % 2 == 0
        out["sel_valid"] = out["sel_valid"] & keep
        return out
    system._seed_program = halved
    return lambda: setattr(system, "_seed_program", orig)


def _ref_shifted():
    from ldso_tpu_torch import system

    orig = system._project_points_to_slot

    def shifted(win, slot):
        uv, idepth, color, valid = orig(win, slot)
        return uv + 0.5, idepth, color, valid
    system._project_points_to_slot = shifted
    return lambda: setattr(system, "_project_points_to_slot", orig)


def _no_keyframe():
    from ldso_tpu_torch import frame_step
    from ldso_tpu_torch.system import FullSystem

    orig_map, orig_track = FullSystem._map_frame, frame_step._track_core

    def voting(*args):
        pyr, gsq, T, ab, diag = orig_track(*args)
        diag = diag.clone()
        diag[frame_step.DIAG_KF_DELTA] = 2.0
        return pyr, gsq, T, ab, diag
    FullSystem._map_frame = lambda self, task: None
    frame_step._track_core = voting

    def undo():
        FullSystem._map_frame = orig_map
        frame_step._track_core = orig_track
    return undo


def _vote_halved():
    from ldso_tpu_torch import frame_step

    orig = frame_step._track_core

    def halved(*args):
        pyr, gsq, T, ab, diag = orig(*args)
        diag = diag.clone()
        diag[frame_step.DIAG_KF_DELTA] *= 0.5
        return pyr, gsq, T, ab, diag
    frame_step._track_core = halved
    return lambda: setattr(frame_step, "_track_core", orig)


@pytest.mark.parametrize("fault,number,from_start", [
    (_trace_unchanged, "trace_rows_parted", False),
    (_pose_altered, "track_energy_gap", False),
    (_ba_unchanged, "ba_solve_gap", False),
    (_ba_one_iteration, "ba_energy_gap", True),
    (_seeds_halved, "seed_rows_parted", True),
    (_ref_shifted, "ref_rows_parted", True),
    (_no_keyframe, "kf_decisions_parted", False),
    (_vote_halved, "kf_delta_gap", False)])
def test_a_planted_fault_is_not_correct(fault, number, from_start):
    """From the window's first frame on, underneath the calls the harness
    keeps: the trace returns the bank unchanged (a step that returns its
    state unchanged); the tracked pose is turned by 0.01 rad where it is
    made (an answer altered where it is produced); the BA's damped solve
    returns no step; the BA stops after one iteration; every second
    gradient seed is dropped; the tracker reference's points move half a
    pixel; every frame votes for a keyframe and none is built; the
    keyframe vote is halved. A fault in a
    function the harness keeps itself is planted before the run starts,
    so that the harness keeps the faulty function's calls."""
    undo = [fault()] if from_start else []
    try:
        res = tiny_cell.drive(3000000013, 2.0, window_hook=None if from_start else
                              lambda: undo.append(fault()))
    finally:
        for u in undo:
            u()
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_a_bootstrap_fault_is_not_correct():
    """The bootstrap's levels (K6) take half their iterations: set-up's
    kept levels read above the limit."""
    from ldso_tpu_torch import init2f

    orig = init2f.init_level
    init2f.init_level = lambda *a, **kw: orig(*a, **{**kw, "iters": max(kw["iters"] // 4, 1)})
    try:
        res = tiny_cell.drive(3000000019, 1.0)
    finally:
        init2f.init_level = orig
    assert res["correct"] is False
    assert res["checks"]["init_energy_gap"]["value"] > res["checks"]["init_energy_gap"]["limit"]


@pytest.mark.gpu
def test_a_cell_on_the_card_is_correct_and_its_control_is_not():
    """On the card (``python -m pytest -m gpu ldso_bench/tests``): one
    walk run at the cell's own size, with the control on its kept calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "ldso_bench/reference/calibrate.py", "--workload",
                          "dso640.walk", "--seeds", "3000000017", "--control", "1",
                          "--seconds", "3"], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    lim = cells.load_config(cells.load_benchmark(), "dso_tum640")["limits"]
    assert line["correct"] is True
    assert any(line["control"].get(k, 0.0) > v for k, v in lim.items())
