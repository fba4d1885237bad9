"""The slice as a whole with loop closure attached: both packages'
FullSystem with a synchronous LoopClosing(train_after=3), at preset
"tiny" with its default corner_fraction (0.3), on tests/test_system.py's
30-frame sequence (seed 0, forward_arc, 320x240, supersample 2)."""

import numpy as np
import pytest
import torch

from ldso_tpu.config import preset as jpreset
from ldso_tpu.loop.closing import LoopClosing as JaxLoopClosing
from ldso_tpu.system import FullSystem as JaxSystem
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.eval.ate import ate_rmse
from ldso_tpu_torch.io.synthetic import SyntheticDataset
from ldso_tpu_torch.kernels.pyramid import build_pyramid
from ldso_tpu_torch.loop.closing import LoopClosing
from ldso_tpu_torch.system import FullSystem


def _ate_pct(system, ds):
    _, poses = system.export_trajectory()
    ids = [fr.frame_id for fr in system.frames][: len(poses)]
    gt = np.stack([ds.gt_pose_c_w(i) for i in ids])
    est_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in poses])
    gt_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in gt])
    rmse, _ = ate_rmse(est_c, gt_c, with_scale=True)
    return 100.0 * rmse / np.linalg.norm(gt_c.max(0) - gt_c.min(0)), len(poses)


def _attach_and_drive(system, lc, ds):
    system.on_keyframe = lc.on_keyframe
    system.loop_closing = lc
    for i in range(ds.num_frames):
        st = system.add_frame(*ds.get_image(i))
        assert st["status"] != "lost", f"lost at frame {i}: {st}"
    return system, lc


@pytest.fixture(scope="module")
def runs():
    ds = SyntheticDataset(w=320, h=240, n=30, traj_kind="forward_arc", seed=0)
    jcfg, tcfg = jpreset("tiny"), preset("tiny")
    jax_run = _attach_and_drive(JaxSystem(jcfg, ds.intrinsics(), ds.w, ds.h),
                                JaxLoopClosing(jcfg, ds.intrinsics(), train_after=3), ds)
    port_run = _attach_and_drive(
        FullSystem(tcfg, ds.intrinsics(), ds.w, ds.h, device="cpu"),
        LoopClosing(tcfg, ds.intrinsics(), train_after=3), ds)
    return ds, jax_run, port_run


def test_snapshots_and_vocabulary(runs):
    # tests/test_system.py::TestLoopSubsystem, in both packages
    _, (js, jlc), (ts, tlc) = runs
    assert ts.cfg.selector.corner_fraction == js.cfg.selector.corner_fraction == 0.3
    for system, lc in ((js, jlc), (ts, tlc)):
        assert len(lc.snapshots) == len(system.kfs)
        assert lc.vocab is not None
        assert len(lc.db) >= len(system.kfs) - 1
        assert not lc.retrain_errors
    assert sorted(tlc.snapshots) == sorted(jlc.snapshots)


def test_first_keyframe_features_identical(runs):
    # both snapshot kf 0 from the same frame-0 image
    _, (_, jlc), (_, tlc) = runs
    fa, fb = jlc.snapshots[0].feats, tlc.snapshots[0].feats
    np.testing.assert_array_equal(fb.uv.numpy(), np.asarray(fa.uv))
    np.testing.assert_array_equal(fb.valid.numpy(), np.asarray(fa.valid))
    v = np.asarray(fa.valid)
    assert v.sum() > 100
    np.testing.assert_allclose(fb.angle.numpy()[v], np.asarray(fa.angle)[v], rtol=0,
                               atol=1e-4)
    # tests/test_torch_orb.py's descriptor bound
    n_diff = (np.unpackbits(np.asarray(fa.desc), axis=1)
              != np.unpackbits(fb.desc.numpy(), axis=1)).sum(axis=1)[v]
    assert (n_diff == 0).mean() >= 0.99 and n_diff.max() <= 2


def test_ate_within_margins(runs):
    # tests/test_torch_system.py's margins
    ds, (js, _), (ts, _) = runs
    a, na = _ate_pct(js, ds)
    b, nb = _ate_pct(ts, ds)
    assert na == nb == ds.num_frames
    assert a < 5.0 and b < 5.0, (a, b)
    assert abs(a - b) < 1.0, (a, b)


def test_relocalization_recovers_pose(runs):
    # tests/test_system.py::TestLoopSubsystem::test_relocalization_recovers_pose
    ds, _, (system, lc) = runs
    kf = sorted(system.kfs.values(), key=lambda k: k.kf_id)[-2]
    img, _, _ = ds.get_image(kf.frame_id + 1)
    pyr, _ = build_pyramid(torch.tensor(np.asarray(img, np.float32)[: system.h, : system.w]),
                           system.cfg.shapes.pyr_levels)
    rel = lc.relocalize(system, pyr)
    assert rel is not None, "relocalization failed on a revisited view"
    gt_rel = ds.gt_pose_c_w(kf.frame_id + 1)
    est_c = -rel["T_cw"][:3, :3].T @ rel["T_cw"][:3, 3]
    kf_c = -kf.T_cw[:3, :3].T @ kf.T_cw[:3, 3]
    gt_c = -gt_rel[:3, :3].T @ gt_rel[:3, 3]
    gt_kf = ds.gt_pose_c_w(kf.frame_id)
    gt_kf_c = -gt_kf[:3, :3].T @ gt_kf[:3, 3]
    assert np.linalg.norm(est_c - kf_c) < max(4.0 * np.linalg.norm(gt_c - gt_kf_c), 0.15)


def test_lost_frame_relocalizes_through_add_frame(runs):
    # the add_frame branch: a lost system with loop closure attached
    # re-anchors on a revisited view and resumes tracking
    ds, _, (system, lc) = runs
    kf = sorted(system.kfs.values(), key=lambda k: k.kf_id)[-1]
    n_frames = system.frame_count
    system.is_lost = True
    try:
        st = system.add_frame(*ds.get_image(kf.frame_id))
        assert st["status"] == "relocalized", st
        assert not system.is_lost and np.isfinite(system.T_last_cw).all()
        assert system.frame_count == n_frames + 1
    finally:
        system.is_lost = False
