"""The slice as a whole: the port's sync FullSystem against the JAX
package's on the same synthetic sequence, at preset "tiny" with
selector.corner_fraction = 0 (gradient seeds only) and at the preset's
own corner_fraction (0.3: FAST/Shi-Tomasi corner seeds too).

30 frames rendered without supersampling: the supersampled 24-frame
sequence leaves the JAX reference itself at 5.5% of extent, above the 5%
bound of tests/test_system.py; here both sit near 3.4%, with margin."""

import dataclasses

import numpy as np
import pytest

from ldso_tpu.config import preset as jpreset
from ldso_tpu.system import FullSystem as JaxSystem
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.eval.ate import ate_rmse
from ldso_tpu_torch.io.synthetic import SyntheticDataset
from ldso_tpu_torch.system import FullSystem

N_FRAMES = 30


def _cfg(p, corner_fraction=0.0):
    base = p("tiny")
    if corner_fraction is None:                 # the preset's own value
        return base
    return base.replace(selector=dataclasses.replace(base.selector,
                                                     corner_fraction=corner_fraction))


def _ate_pct(system, ds):
    _, poses = system.export_trajectory()
    ids = [fr.frame_id for fr in system.frames][: len(poses)]
    gt = np.stack([ds.gt_pose_c_w(i) for i in ids])
    est_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in poses])
    gt_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in gt])
    rmse, _ = ate_rmse(est_c, gt_c, with_scale=True)
    return 100.0 * rmse / np.linalg.norm(gt_c.max(0) - gt_c.min(0)), len(poses)


def _drive(system, ds):
    statuses = []
    for i in range(ds.num_frames):
        st = system.add_frame(*ds.get_image(i))
        statuses.append(st["status"])
    return statuses


def _both_runs(corner_fraction):
    ds = SyntheticDataset(w=320, h=240, n=N_FRAMES, traj_kind="forward_arc", seed=0,
                          supersample=1)
    jsys = JaxSystem(_cfg(jpreset, corner_fraction), ds.intrinsics(), ds.w, ds.h)
    tsys = FullSystem(_cfg(preset, corner_fraction), ds.intrinsics(), ds.w, ds.h,
                      device="cpu")
    return ds, (jsys, _drive(jsys, ds)), (tsys, _drive(tsys, ds))


@pytest.fixture(scope="module")
def runs():
    return _both_runs(0.0)


@pytest.fixture(scope="module")
def runs_default():
    return _both_runs(None)


def _check_initialize_within_one_frame(runs):
    _, (js, jst), (ts, tst) = runs
    assert js.initialized and ts.initialized
    assert abs(jst.index("initialized") - tst.index("initialized")) <= 1


def _check_track_every_frame(runs):
    ds, (js, jst), (ts, tst) = runs
    for system, statuses in ((js, jst), (ts, tst)):
        assert "lost" not in statuses and not system.is_lost
        assert _ate_pct(system, ds)[1] == ds.num_frames


def _check_keyframe_counts_close(runs):
    _, (js, _), (ts, _) = runs
    assert len(ts.kfs) >= 3
    assert abs(len(js.kfs) - len(ts.kfs)) <= 2


def _check_ate_bounds_and_agreement(runs):
    ds, (js, _), (ts, _) = runs
    a, _ = _ate_pct(js, ds)
    b, _ = _ate_pct(ts, ds)
    assert a < 5.0 and b < 5.0, (a, b)          # tests/test_system.py's bound
    assert abs(a - b) < 1.0, (a, b)             # percentage points


def _check_state_alive(runs):
    _, _, (ts, _) = runs
    assert int(ts.win.p_valid.sum()) > 50
    assert ts.immatures.valid.sum() > 20
    n_in = sum(1 for k in ts.kfs.values() if k.in_window)
    assert n_in <= ts.cfg.window.max_kf + 1


def test_both_initialize_within_one_frame(runs):
    _check_initialize_within_one_frame(runs)


def test_both_track_every_frame(runs):
    _check_track_every_frame(runs)


def test_keyframe_counts_close(runs):
    _check_keyframe_counts_close(runs)


def test_ate_bounds_and_agreement(runs):
    _check_ate_bounds_and_agreement(runs)


def test_state_alive(runs):
    _check_state_alive(runs)


@pytest.mark.parametrize("check", [_check_initialize_within_one_frame,
                                   _check_track_every_frame,
                                   _check_keyframe_counts_close,
                                   _check_ate_bounds_and_agreement,
                                   _check_state_alive],
                         ids=lambda f: f.__name__[len("_check_"):])
def test_default_corner_fraction(runs_default, check):
    # the same asserts as the corner_fraction = 0 cases above
    assert runs_default[2][0].cfg.selector.corner_fraction == 0.3
    check(runs_default)


def test_default_corner_seeds_reach_the_bank(runs_default):
    _, (js, _), (ts, _) = runs_default
    assert int(ts.immatures.is_corner.sum()) > 0
    assert int(np.asarray(js.immatures.is_corner).sum()) > 0


def test_default_preset_builds():
    cfg = preset("default")
    assert cfg.selector.corner_fraction > 0
    system = FullSystem(cfg, np.asarray([200.0, 200.0, 80.0, 60.0]), 160, 128, device="cpu")
    assert system.on_keyframe is None and system.loop_closing is None


@pytest.fixture
def single_torch_thread():
    # two Python threads that each enter torch's thread pool oversubscribe a
    # machine that runs one test process per core; one thread is as fast here
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [dict(async_mapping=True), dict(pipeline_depth=2),
                                dict(batch_size=4), dict(corner_fraction=0.3)])
def test_unported_modes_raise(kw, single_torch_thread):
    # these modes raised before they were ported; each now constructs,
    # takes a few frames and shuts down cleanly. pipeline_depth and
    # batch_size without async_mapping fall back to sync, as in the
    # reference; the corner_fraction case runs the full async + pipelined
    # + batched mode on top of the default corner seeding.
    kw = dict(kw)
    cfg = _cfg(preset, kw.pop("corner_fraction", 0.0))
    kw = kw or dict(async_mapping=True, pipeline_depth=8, batch_size=4)
    ds = SyntheticDataset(w=160, h=120, n=10, traj_kind="forward_arc", seed=0, supersample=1)
    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device="cpu", **kw)
    is_async = bool(kw.get("async_mapping"))
    assert (system._map_thread is not None) == is_async
    assert system.pipeline_depth == (kw.get("pipeline_depth", 0) if is_async else 0)
    assert system.batch_size == (kw.get("batch_size", 1) if system.pipeline_depth else 1)
    thread = system._map_thread
    try:
        for i in range(ds.num_frames):
            st = system.add_frame(*ds.get_image(i))
            assert st["status"] != "lost", st
        system.finish_mapping()
    finally:
        system.shutdown()
    assert system.frame_count == ds.num_frames and not system._pending
    assert thread is None or not thread.is_alive()
    assert system._map_thread is None


def test_attaching_loop_closure_raises():
    # raised for the async worker before it was ported: both variants
    # attach now, and the worker starts, drains and stops
    from ldso_tpu_torch.loop import closing

    system = FullSystem(_cfg(preset), np.asarray([200.0, 200.0, 80.0, 60.0]), 160, 120,
                        device="cpu")
    lc = closing.LoopClosing(system.cfg, system.intr)
    system.on_keyframe = lc.on_keyframe
    system.loop_closing = lc
    assert system.loop_closing is lc and system.on_keyframe == lc.on_keyframe
    alc = closing.AsyncLoopClosing(system.cfg, system.intr)
    thread = alc._thread
    try:
        system.on_keyframe = alc.on_keyframe
        system.loop_closing = alc
        assert thread.is_alive() and alc.results == []
        alc.finish()
    finally:
        alc.shutdown()
    thread.join(timeout=10.0)
    assert not thread.is_alive() and alc._thread is None
