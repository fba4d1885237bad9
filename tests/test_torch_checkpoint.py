"""Checkpoints of the port: save, load, resume; and a checkpoint written by
the JAX package loaded in the port.

Tolerances: a resumed port run must reproduce the uninterrupted one to 1e-3
in position (the bound of tests/test_system.py::TestCheckpointResume; on
the CPU it is reproduced to ~1e-7). A port run resumed from a JAX-written
checkpoint is held to 1e-2 against the JAX run over the next 7 frames: the
two engines agree to float32 rounding per frame and part at the frame level
over longer stretches (ROADMAP G2), so this is not a bitwise claim."""

import dataclasses

import numpy as np
import pytest
import torch

from ldso_tpu.config import preset as jpreset
from ldso_tpu.io import checkpoint as jckpt
from ldso_tpu.io.synthetic import SyntheticDataset
from ldso_tpu.system import FullSystem as JaxSystem
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from ldso_tpu_torch.system import FullSystem

CFG = preset("tiny")
N, K = 30, 22                 # frames; the checkpoint is taken after frame K-1


def _run(system, ds, start, end):
    out = []
    for i in range(start, end):
        st = system.add_frame(*ds.get_image(i))
        assert st["status"] != "lost", f"lost at frame {i}: {st}"
        out.append(st)
    return out


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    # the tiny preset's small eager ops gain nothing from intra-op threads,
    # and several test processes side by side lose a great deal to them
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return SyntheticDataset(w=320, h=240, n=N, traj_kind="forward_arc", seed=0)


@pytest.fixture(scope="module")
def port_run(ds, tmp_path_factory):
    """The port up to frame K-1, two checkpoints on the way (after a
    keyframe's frame and after a plain frame), then on to the end."""
    tmp = tmp_path_factory.mktemp("ckpt")
    a = FullSystem(CFG, ds.intrinsics(), ds.w, ds.h, device="cpu")
    sts = _run(a, ds, 0, K)
    i_kf = max(i for i, st in enumerate(sts) if st.get("need_kf"))
    assert i_kf < K - 1, "the fixture wants plain frames after the last keyframe"
    save_checkpoint(a, str(tmp / "plain"))
    seed = dict(ab=a.last_rel_ab.copy(), version_ok=a._last_rel_ab_version == a._ref_version,
                n_frames=len(a.frames))
    sts += _run(a, ds, K, N)
    return a, sts, str(tmp / "plain"), seed, i_kf, tmp


def test_resume_reproduces_run(ds, port_run):
    a, sts, path, _, _, _ = port_run
    assert any(st.get("need_kf") for st in sts[K:]), "no keyframe after the resume point"
    b = load_checkpoint(path, CFG, device="cpu")
    assert b.frame_count == K and b.initialized and not b.is_lost
    _run(b, ds, K, N)
    _, pa = a.export_trajectory()
    _, pb = b.export_trajectory()
    assert len(pa) == len(pb) == N
    np.testing.assert_allclose(pa[:, :3, 3], pb[:, :3, 3], atol=1e-3)
    assert sorted(a.kfs) == sorted(b.kfs)


def test_seed_tag_survives_a_resume(ds, port_run):
    # ROADMAP F7: the restored relative affine must carry the ref version
    # that _update_tracker_ref leaves, or the first resumed frame starts
    # from a zero affine
    _, _, path, seed, _, _ = port_run
    assert seed["version_ok"] and np.abs(seed["ab"]).max() > 0
    b = load_checkpoint(path, CFG, device="cpu")
    assert b._last_rel_ab_version == b._ref_version == b._dispatch_ref_version
    np.testing.assert_array_equal(b.last_rel_ab, seed["ab"])
    assert b.last_rel_ab.dtype == np.float32
    assert b._next_kf_version == b._ref_version + 1 and b._ref_version in b._kf_base
    assert not b._pending and not b._fbuf


def test_port_state_is_restored_exactly(ds, tmp_path):
    # the tracker ref as it was built, the device-carried prediction pair,
    # the versions and the activation ladder: equal, not close
    a = FullSystem(CFG, ds.intrinsics(), ds.w, ds.h, device="cpu")
    _run(a, ds, 0, 18)
    save_checkpoint(a, str(tmp_path / "c"))
    b = load_checkpoint(str(tmp_path / "c"), CFG, device="cpu")
    for x, y in zip(a.track_ref, b.track_ref):
        for u, v in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            assert u.dtype == v.dtype and torch.equal(u, v)
    for name in ("_T_ref_cw_dev", "_T_last_rel", "_T_prelast_rel", "_ab_rel_dev",
                 "_dispatch_T_ref_dev"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_array_equal(a._T_ref_cw_np, b._T_ref_cw_np)
    for name in ("_ref_version", "_dispatch_ref_version", "_next_kf_version", "_kf_base",
                 "_min_act_dist", "_n_active_cache", "first_coarse_rmse", "frame_count"):
        assert getattr(a, name) == getattr(b, name), name
    assert a._min_act_dist != CFG.selector.min_act_dist     # the ladder had moved
    for x, y in zip(a.win, b.win):
        assert torch.equal(torch.nan_to_num(x.float()), torch.nan_to_num(y.float()))


def test_file_without_the_port_state_is_rebuilt(ds, port_run, tmp_path):
    # a port file stripped to what the JAX package writes: the loader
    # rebuilds the ref, the prediction pair and the axis, and the run
    # still resumes within the bound on this sequence
    import json

    a, _, path, _, _, _ = port_run
    with np.load(path + ".npz") as npz:
        arrays = {k: npz[k] for k in npz.files if not k.startswith("port_")}
    np.savez_compressed(str(tmp_path / "bare.npz"), **arrays)
    meta = json.load(open(path + ".json"))
    del meta["port"]
    json.dump(meta, open(str(tmp_path / "bare.json"), "w"))
    b = load_checkpoint(str(tmp_path / "bare"), CFG, device="cpu")
    assert b._ref_version == b._dispatch_ref_version == b._last_rel_ab_version == 1
    assert b._min_act_dist == CFG.selector.min_act_dist and b.track_ref is not None
    _run(b, ds, K, N)
    np.testing.assert_allclose(a.export_trajectory()[1][:, :3, 3],
                               b.export_trajectory()[1][:, :3, 3], atol=1e-3)


def test_seed_measured_against_a_replaced_ref_is_saved_as_zero(ds, port_run, tmp_path):
    # right after a keyframe's frame the last affine belongs to the old ref:
    # the next track starts from zero, in the live run and after a resume
    _, sts, _, _, i_kf, _ = port_run
    a = FullSystem(CFG, ds.intrinsics(), ds.w, ds.h, device="cpu")
    _run(a, ds, 0, i_kf + 1)
    assert a._last_rel_ab_version != a._ref_version and np.abs(a.last_rel_ab).max() > 0
    save_checkpoint(a, str(tmp_path / "kf"))
    b = load_checkpoint(str(tmp_path / "kf"), CFG, device="cpu")
    np.testing.assert_array_equal(b.last_rel_ab, np.zeros(2, np.float32))
    _run(a, ds, i_kf + 1, i_kf + 4)
    _run(b, ds, i_kf + 1, i_kf + 4)
    np.testing.assert_allclose(a.export_trajectory()[1][:, :3, 3],
                               b.export_trajectory()[1][:, :3, 3], atol=1e-3)


def test_file_holds_the_reference_names(port_run):
    _, _, path, seed, _, _ = port_run
    import json

    from ldso_tpu_torch.core.bank import Bank
    from ldso_tpu_torch.core.window import Window

    with np.load(path + ".npz") as npz:
        names = set(npz.files)
        assert npz["HM"].dtype == np.float64 and npz["win_p_host"].dtype == np.int32
    want = {f"win_{f}" for f in Window._fields} | {f"imm_{f}" for f in Bank._fields} \
        | {"HM", "bM", "last_rel_ab", "T_last_cw", "T_prelast_cw", "kf_T_0", "fr_T_0"}
    assert want <= names
    # what the reference's file has no name for goes under the port's own
    assert names <= want | {n for n in names
                            if n.split("_")[0] in ("kf", "fr", "edge", "map", "port")}
    meta = json.load(open(path + ".json"))
    assert set(meta["port"]) == {"ref_version", "dispatch_ref_version", "next_kf_version",
                                 "kf_base", "min_act_dist", "n_active"}
    assert set(meta) == {"port", "kfs", "frames", "edges", "slot_kf", "next_kf_id", "frame_count",
                         "initialized", "is_lost", "ref_kf", "first_coarse_rmse", "w", "h",
                         "intr", "has_T_last", "has_T_prelast"}
    assert len(meta["frames"]) == seed["n_frames"] == K


@pytest.mark.parametrize("change,array", [
    (dict(max_frames=CFG.shapes.max_frames + 2), "win_frame_valid"),
    (dict(max_points=CFG.shapes.max_points * 2), "win_p_valid"),
    (dict(max_immature=CFG.shapes.max_immature // 2), "imm_valid"),
])
def test_shape_mismatch_raises(port_run, change, array):
    _, _, path, _, _, _ = port_run
    cfg = CFG.replace(shapes=dataclasses.replace(CFG.shapes, **change))
    with pytest.raises(ValueError) as e:
        load_checkpoint(path, cfg, device="cpu")
    with np.load(path + ".npz") as npz:
        have = tuple(npz[array].shape)
    msg = str(e.value)
    assert repr(array) in msg and str(have) in msg and "expects" in msg


def test_prior_shape_is_checked(port_run, tmp_path):
    _, _, path, _, _, _ = port_run
    import shutil

    with np.load(path + ".npz") as npz:
        arrays = {k: npz[k] for k in npz.files}
    arrays["HM"] = arrays["HM"][:-1, :-1]
    np.savez_compressed(str(tmp_path / "bad.npz"), **arrays)
    shutil.copy(path + ".json", str(tmp_path / "bad.json"))
    with pytest.raises(ValueError, match="'HM'"):
        load_checkpoint(str(tmp_path / "bad"), CFG, device="cpu")


def test_checkpoint_of_an_async_system_drains_first(ds, tmp_path):
    a = FullSystem(CFG, ds.intrinsics(), ds.w, ds.h, device="cpu", async_mapping=True,
                   pipeline_depth=4)
    try:
        for i in range(14):
            a.add_frame(*ds.get_image(i))
        save_checkpoint(a, str(tmp_path / "async"))
        assert not a._pending and not a._map_queue and not a._map_busy
        n_frames = len(a.frames)
    finally:
        a.shutdown()
    b = load_checkpoint(str(tmp_path / "async"), CFG, device="cpu")
    assert len(b.frames) == n_frames == 14 and b.frame_count == 14
    assert sorted(b.kfs) == sorted(a.kfs)
    assert _run(b, ds, 14, 16)[-1]["status"] == "tracked"


def test_jax_checkpoint_loads_in_the_port(ds, tmp_path):
    jsys = JaxSystem(jpreset("tiny"), ds.intrinsics(), ds.w, ds.h)
    _run(jsys, ds, 0, 15)
    path = str(tmp_path / "jax_ckpt")
    jckpt.save_checkpoint(jsys, path)
    tsys = load_checkpoint(path, CFG, device="cpu")
    assert tsys.frame_count == 15 and tsys.initialized
    assert sorted(tsys.kfs) == sorted(jsys.kfs) and tsys.ref_kf == jsys.ref_kf
    assert tsys.win.p_host.dtype == torch.int32 and tsys.win.images.dtype == torch.float32
    assert int(tsys.win.p_valid.sum()) == int(np.asarray(jsys.win.p_valid).sum()) > 50
    assert tsys.immatures.valid.sum() == np.asarray(jsys.immatures.valid).sum() > 20
    np.testing.assert_array_equal(tsys.HM, np.asarray(jsys.HM))
    _run(jsys, ds, 15, 22)
    _run(tsys, ds, 15, 22)
    _, pj = jsys.export_trajectory()
    _, pt = tsys.export_trajectory()
    assert len(pj) == len(pt) == 22
    # the 15 restored frames hang on keyframe poses that later BA rounds
    # refine in both runs; the 7 new ones are the port's own (seen on the
    # CPU: 1.8e-5 on the restored frames, 7.4e-5 on the new ones)
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], atol=1e-2)
    # and a JAX-written file of other shapes is refused as well
    cfg = CFG.replace(shapes=dataclasses.replace(CFG.shapes, max_frames=CFG.shapes.max_frames + 1))
    with pytest.raises(ValueError, match="win_"):
        load_checkpoint(path, cfg, device="cpu")
