"""Evaluation, trajectory files, metrics and the offline dumps of the port
against the JAX package's. ``drift_per_distance`` and the TUM reader are
numpy copies and must be equal; the TUM writer takes its quaternion from
the port's ``math/lie`` (float64 here), so two files are compared number by
number to 2e-6 (the files carry 6-7 decimals); ``global_map_points`` and
the PLY are compared to 1e-4 on identical state (float32 products of
coordinates of order 10)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu import viz as jviz
from ldso_tpu.config import preset as jpreset
from ldso_tpu.core.window import Window as JWindow
from ldso_tpu.eval import ate as jate
from ldso_tpu.system import FullSystem as JaxSystem
from ldso_tpu_torch import convert, viz as tviz
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.eval import ate as tate
from ldso_tpu_torch.io.synthetic import SyntheticDataset
from ldso_tpu_torch.math import lie
from ldso_tpu_torch.system import FullSystem

RNG = np.random.default_rng(1)


def _poses(n):
    xi = torch.from_numpy(RNG.normal(size=(n, 6)) * 0.3)
    return lie.se3_exp(xi).numpy().astype(np.float64)


def test_drift_per_distance_copy_equals_original():
    t = np.linspace(0, 6, 200)
    gt = np.stack([np.cos(t), 0.2 * t, np.sin(t)], -1) * 3.0
    est = 0.6 * gt @ np.linalg.qr(RNG.normal(size=(3, 3)))[0].T \
        + np.cumsum(RNG.normal(size=gt.shape) * 2e-3, axis=0)
    a, b = jate.drift_per_distance(est, gt), tate.drift_per_distance(est, gt)
    assert a == b and set(b) == {0.1, 0.25, 0.5}
    assert all(np.isfinite(v) and v > 0 for v in b.values())
    assert jate.drift_per_distance(est, gt, seg_fracs=(0.3,)) == \
        tate.drift_per_distance(est, gt, seg_fracs=(0.3,))


def test_tum_io_roundtrip(tmp_path):
    # tests/test_foundations.py::TestATE::test_tum_io_roundtrip on the port
    n = 10
    poses = _poses(n)
    path = str(tmp_path / "traj.txt")
    tate.write_tum_trajectory(path, np.arange(n, dtype=float), poses)
    ts, pos, quat = tate.read_tum_trajectory(path)
    assert ts.shape == (n,) and pos.shape == (n, 3) and quat.shape == (n, 4)
    for i in range(n):
        Twc = np.linalg.inv(poses[i])
        np.testing.assert_allclose(pos[i], Twc[:3, 3], atol=1e-5)
        R = lie.quat_to_matrix(torch.from_numpy(quat[i])).numpy()
        np.testing.assert_allclose(R, Twc[:3, :3], atol=1e-5)


def test_tum_files_of_both_packages_agree(tmp_path):
    n = 12
    poses, ts = _poses(n), np.arange(n) * 0.05 + 1403636579.76
    pa, pb = str(tmp_path / "jax.txt"), str(tmp_path / "torch.txt")
    jate.write_tum_trajectory(pa, ts, poses)
    tate.write_tum_trajectory(pb, ts, poses)
    for x, y in zip(jate.read_tum_trajectory(pa), tate.read_tum_trajectory(pb)):
        np.testing.assert_allclose(y, x, atol=2e-6, rtol=0)
    # and each package reads the other's file alike, comments skipped
    with open(pb, "a") as f:
        f.write("# a comment\n\n")
    for x, y in zip(jate.read_tum_trajectory(pb), tate.read_tum_trajectory(pb)):
        np.testing.assert_array_equal(x, y)


def test_write_ply_and_gray_image_equal_the_originals(tmp_path):
    xyz = RNG.normal(size=(40, 3)) * 5
    inten = RNG.uniform(-20, 300, 40)
    for name, col in (("a", inten), ("b", None)):
        jviz.write_ply(str(tmp_path / f"j{name}.ply"), xyz, col)
        tviz.write_ply(str(tmp_path / f"t{name}.ply"), xyz, col)
        assert (tmp_path / f"j{name}.ply").read_text() == (tmp_path / f"t{name}.ply").read_text()
    lines = (tmp_path / "ta.ply").read_text().splitlines()
    assert lines[0] == "ply" and "element vertex 40" in lines and len(lines) == 40 + 10
    img = RNG.uniform(-10, 280, (12, 16))
    tviz._save_gray_image(str(tmp_path / "g.png"), img)
    assert any(n.startswith("g.") for n in os.listdir(tmp_path))


def test_dump_trajectory(tmp_path):
    poses = _poses(8)
    tviz.dump_trajectory(str(tmp_path / "out"), poses, _poses(8))
    assert set(os.listdir(tmp_path / "out")) & {"trajectory.png", "trajectory_xyz.txt"}
    np.testing.assert_array_equal(tviz._centers(poses), jviz._centers(poses))


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    # the tiny preset's small eager ops gain nothing from intra-op threads,
    # and several test processes side by side lose a great deal to them
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tracked():
    # long enough at preset "tiny" for keyframes to leave the window
    ds = SyntheticDataset(w=320, h=240, n=40, traj_kind="forward_arc", seed=3,
                          scene_kind="corridor", supersample=1)
    system = FullSystem(preset("tiny"), ds.intrinsics(), ds.w, ds.h, device="cpu")
    statuses = [system.add_frame(*ds.get_image(i)) for i in range(ds.num_frames)]
    return ds, system, statuses


def test_metrics_one_record_per_tracked_frame(tracked, tmp_path):
    _, system, statuses = tracked
    tr = [st for st in statuses if st["status"] == "tracked"]
    assert len(system.metrics) == len(tr) > 10
    for m, st in zip(system.metrics, tr):
        assert m["frame"] == st["frame_id"] and "status" not in m
        assert m["rmse"] == st["rmse"] and m["need_kf"] == st["need_kf"]
    # a keyframe's record carries its BA results in sync mode, as in the reference
    assert any("ba_energy" in m for m in system.metrics)
    path = str(tmp_path / "metrics.jsonl")
    system.write_metrics(path)
    rows = [json.loads(line) for line in open(path)]
    assert [r["frame"] for r in rows] == [m["frame"] for m in system.metrics]
    assert rows[-1]["flow"] == system.metrics[-1]["flow"]


def test_global_map_points_matches_the_reference_on_the_same_state(tracked):
    _, system, _ = tracked
    assert any(not k.in_window for k in system.kfs.values()) and system.map_points
    # the same state in a JAX system: window, registries, archived points
    jsys = JaxSystem(jpreset("tiny"), system.intr, system.w, system.h)
    arrays = convert.to_numpy(system.win)
    jsys.win = JWindow(**{f: jnp.asarray(arrays[f]) for f in JWindow._fields})
    jsys.kfs, jsys.map_points, jsys.slot_kf = system.kfs, system.map_points, system.slot_kf
    # one archived keyframe gets a pose-graph Sim(3), which must win over T_cw
    kid = next(iter(system.map_points))
    S = system.kfs[kid].T_cw.copy()
    S[:3, :3] *= 1.1
    system.kfs[kid].S_cw_opti = S
    try:
        for include_window in (True, False):
            xa, ca = jsys.global_map_points(include_window)
            xb, cb = system.global_map_points(include_window)
            assert xb.shape == xa.shape and xb.shape[1] == 3 and len(cb) == len(xb) > 0
            np.testing.assert_allclose(xb, xa, atol=1e-4, rtol=1e-5)
            np.testing.assert_array_equal(cb, ca)
        n_arch = sum(len(d["color"]) for d in system.map_points.values())
        assert len(system.global_map_points(False)[0]) == n_arch
        assert len(system.global_map_points(True)[0]) == n_arch + int(system.win.p_valid.sum())
    finally:
        system.kfs[kid].S_cw_opti = None
    empty = FullSystem(preset("tiny"), system.intr, 64, 48, device="cpu")
    xyz, col = empty.global_map_points()
    assert xyz.shape == (0, 3) and col.shape == (0,)


def test_dump_map_writes_the_cloud_and_the_overlays(tracked, tmp_path):
    _, system, _ = tracked
    n = tviz.dump_map(str(tmp_path / "viz"), system)
    assert n == len(system.global_map_points(True)[0]) > 0
    names = os.listdir(tmp_path / "viz")
    assert "map.ply" in names
    in_window = [k for k in system.slot_kf if k is not None]
    assert all(any(x.startswith(f"depth_kf{k}.") for x in names) for k in in_window)
    with open(tmp_path / "viz" / "map.ply") as f:
        assert f"element vertex {n}" in f.read(300)
    assert tviz.dump_map(str(tmp_path / "none"),
                         FullSystem(preset("tiny"), system.intr, 64, 48, device="cpu")) == 0


def test_bank_from_host_round_trip(tracked):
    from ldso_tpu_torch.core import bank as bank_mod

    _, system, _ = tracked
    host = bank_mod.to_host(system.bank)
    back = bank_mod.from_host(host, "cpu")
    for f in bank_mod.Bank._fields:
        a, b = getattr(system.bank, f), getattr(back, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(torch.nan_to_num(a.float(), nan=-7.0),
                           torch.nan_to_num(b.float(), nan=-7.0)), f
    # float64 / int64 host arrays (a file written with 64-bit types) are narrowed
    wide = host._replace(uv=host.uv.astype(np.float64),
                         host_slot=host.host_slot.astype(np.int64))
    assert bank_mod.from_host(wide, "cpu").uv.dtype == torch.float32
    assert bank_mod.from_host(wide, "cpu").host_slot.dtype == torch.int32
