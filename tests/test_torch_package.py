"""The port as a package: no JAX at import, the copied framework-neutral
modules equal their originals, and the state converter round-trips."""

import ast
import dataclasses
import glob
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

import ldso_tpu.config as jcfg
import ldso_tpu.eval.ate as jate
import ldso_tpu.io.synthetic as jsyn
import ldso_tpu_torch.config as tcfg
import ldso_tpu_torch.eval.ate as tate
import ldso_tpu_torch.io.synthetic as tsyn
from ldso_tpu_torch import convert


def test_import_pulls_in_no_jax():
    code = ("import sys; import ldso_tpu_torch, ldso_tpu_torch.system, "
            "ldso_tpu_torch.convert, ldso_tpu_torch.kernels.pallas_pyramid, "
            "ldso_tpu_torch.kernels.track_level, ldso_tpu_torch.kernels.cuda_build, "
            "ldso_tpu_torch.loop.orb, ldso_tpu_torch.loop.match, "
            "ldso_tpu_torch.loop.bow, ldso_tpu_torch.loop.sim3, "
            "ldso_tpu_torch.loop.posegraph, ldso_tpu_torch.loop.closing, "
            "ldso_tpu_torch.cameras, ldso_tpu_torch.io.photometric, "
            "ldso_tpu_torch.io.datasets, ldso_tpu_torch.io.checkpoint, "
            "ldso_tpu_torch.native, ldso_tpu_torch.viz, ldso_tpu_torch.cli, "
            "ldso_tpu_torch.eval.ate, ldso_tpu_torch.eval.toys, "
            "ldso_tpu_torch.distributed.mesh, ldso_tpu_torch.distributed.sharded_ba, "
            "ldso_tpu_torch.distributed.sharded_pgo, ldso_tpu_torch.graft_entry; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ldso_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    files = glob.glob(os.path.join(ROOT, "ldso_tpu_torch", "**", "*.py"), recursive=True)
    files += glob.glob(os.path.join(ROOT, "scripts", "torch_*.py"))
    return sorted(files + [os.path.join(ROOT, "chip_smoke.py")])


def test_no_source_of_the_port_names_jax_in_an_import():
    # every import statement of the port, chip_smoke.py and scripts/torch_*.py,
    # also those inside functions, which the subprocess above does not reach
    files = _port_sources()
    assert len(files) > 40
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "ldso_tpu")]
    assert not bad, bad


def _dc_tree(obj):
    """Dataclass instance -> nested (class name, field, default) tuples."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                tuple((f.name, _dc_tree(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    return obj


@pytest.mark.parametrize("name", ["default", "realtime", "fast", "tiny"])
def test_config_copy_equals_original(name):
    # field for field, default for default, preset for preset
    assert _dc_tree(tcfg.preset(name)) == _dc_tree(jcfg.preset(name))
    assert tcfg.PATTERN == jcfg.PATTERN
    assert tcfg.PATTERN_PADDING == jcfg.PATTERN_PADDING
    assert tcfg.Shapes().state_dim == jcfg.Shapes().state_dim


def test_synthetic_copy_renders_identical_frames():
    kw = dict(w=96, h=64, n=3, seed=5, traj_kind="forward_arc", supersample=1)
    a, b = jsyn.SyntheticDataset(**kw), tsyn.SyntheticDataset(**kw)
    for i in range(3):
        ia, ib = a.get_image(i), b.get_image(i)
        assert ia[0].tobytes() == ib[0].tobytes()
        assert ia[1:] == ib[1:]
        assert a.get_idepth(i).tobytes() == b.get_idepth(i).tobytes()
    np.testing.assert_array_equal(a.poses_w_c, b.poses_w_c)
    np.testing.assert_array_equal(a.intrinsics(), b.intrinsics())
    assert tuple(a.calib.out_intr) == tuple(b.calib.out_intr)


def test_ate_copy_equals_original():
    rng = np.random.default_rng(1)
    gt = rng.normal(size=(40, 3))
    est = 0.7 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.01 * rng.normal(size=(40, 3))
    ra, ea = jate.ate_rmse(est, gt)
    rb, eb = tate.ate_rmse(est, gt)
    assert ra == rb
    np.testing.assert_array_equal(ea, eb)
    for x, y in zip(jate.umeyama(est, gt), tate.umeyama(est, gt)):
        np.testing.assert_array_equal(x, y)


def _same_source(a, b, names):
    for name in names:
        fa, fb = a, b
        for part in name.split("."):
            fa, fb = getattr(fa, part), getattr(fb, part)
        assert inspect.getsource(fa) == inspect.getsource(fb), name


def test_native_loader_copy_is_byte_identical():
    with open(os.path.join(ROOT, "ldso_tpu", "native", "loader.cc"), "rb") as f:
        original = f.read()
    with open(os.path.join(ROOT, "ldso_tpu_torch", "native", "loader.cc"), "rb") as f:
        assert f.read() == original


@pytest.mark.parametrize("module,names", [
    ("cameras", ["_distort_fov", "_distort_radtan", "_distort_equidistant",
                 "_relative_to_absolute", "make_remap", "find_crop_intrinsics",
                 "parse_calib_text", "pinhole_calib"]),
    ("eval.ate", ["umeyama", "ate_rmse", "drift_per_distance", "read_tum_trajectory"]),
    ("io.datasets", ["_decode_png_gray", "_decode_pgm", "EurocDataset._parse_sensor_yaml"]),
    ("io.photometric", ["PhotometricCalib", "parse_pcalib_text"]),
    ("viz", ["_centers", "write_ply", "_save_gray_image", "dump_trajectory"]),
])
def test_numpy_halves_are_copies_of_the_originals(module, names):
    import importlib

    j = importlib.import_module(f"ldso_tpu.{module}")
    t = importlib.import_module(f"ldso_tpu_torch.{module}")
    _same_source(j, t, names)
    if module == "cameras":
        assert sorted(t._DISTORT) == sorted(j._DISTORT)
        assert [f.name for f in dataclasses.fields(t.CameraCalib)] == \
            [f.name for f in dataclasses.fields(j.CameraCalib)]


def test_brief_pairs_copy_equals_original():
    from ldso_tpu.loop import orb as jorb
    from ldso_tpu_torch.loop import orb as torb

    assert torb.BRIEF_PAIRS.dtype == jorb.BRIEF_PAIRS.dtype
    np.testing.assert_array_equal(torb.BRIEF_PAIRS, jorb.BRIEF_PAIRS)
    np.testing.assert_array_equal(torb.FAST_OFFSETS, jorb.FAST_OFFSETS)
    assert (torb.PATCH_R, torb.DESC_BITS, torb.DESC_BYTES) == \
        (jorb.PATCH_R, jorb.DESC_BITS, jorb.DESC_BYTES)


def _assert_same_vocab(tv, jv):
    """Port Vocabulary (CPU tensors) == reference Vocabulary, array for array."""
    assert (tv.k, tv.levels) == (jv.k, jv.levels)
    for a, b in zip(tv.tables + tv.table_valid + (tv.idf,),
                    jv.tables + jv.table_valid + (jv.idf,)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,levels,max_train", [(4, 3, 60000), (6, 2, 500)])
def test_bow_training_copy_equals_original(k, levels, max_train):
    from ldso_tpu.loop import bow as jbow
    from ldso_tpu_torch.loop import bow as tbow

    rng = np.random.default_rng(0)
    desc = rng.integers(0, 256, size=(600, 32), dtype=np.uint8)
    _assert_same_vocab(tbow.train_vocabulary(desc, k=k, levels=levels, seed=3,
                                             max_train=max_train, device="cpu"),
                       jbow.train_vocabulary(desc, k=k, levels=levels, seed=3,
                                             max_train=max_train))
    bits = rng.integers(0, 2, size=(7, 256)).astype(np.float32)
    np.testing.assert_array_equal(tbow._pack(bits), jbow._pack(bits))


def test_bow_text_converter_copy_equals_original():
    from ldso_tpu.loop import bow as jbow
    from ldso_tpu_torch.loop import bow as tbow

    rng = np.random.default_rng(1)
    desc = rng.integers(0, 256, size=(400, 32), dtype=np.uint8)
    jv = jbow.train_vocabulary(desc, k=4, levels=3, seed=0)
    tv = tbow.train_vocabulary(desc, k=4, levels=3, seed=0, device="cpu")
    text = jbow.save_vocabulary_text(jv)
    assert tbow.save_vocabulary_text(tv) == text
    for trunc in (None, 2):
        _assert_same_vocab(tbow.load_vocabulary_text(text, truncate_levels=trunc,
                                                     device="cpu"),
                           jbow.load_vocabulary_text(text, truncate_levels=trunc))
    # a foreign tree with early leaves (tests/test_loop.py's hand-built one)
    d = [" ".join(str(x) for x in rng.integers(0, 256, 32)) for _ in range(6)]
    lines = "\n".join(["2 3 0 0", f"0 0 {d[0]} 0", f"0 1 {d[1]} 0.5", f"1 0 {d[2]} 0",
                       f"1 1 {d[3]} 0.25", f"3 1 {d[4]} 0.75", f"3 1 {d[5]} 1.25"])
    _assert_same_vocab(tbow.load_vocabulary_text(lines, device="cpu"),
                       jbow.load_vocabulary_text(lines))


def test_build_edges_copy_equals_original():
    from ldso_tpu.loop import posegraph as jpg
    from ldso_tpu.system import PoseEdge as JEdge
    from ldso_tpu_torch.loop import posegraph as tpg
    from ldso_tpu_torch.system import PoseEdge as TEdge

    rng = np.random.default_rng(2)
    raw = [(int(a), int(b), rng.normal(size=(4, 4)), kind)
           for a, b, kind in zip(rng.integers(0, 9, 12), rng.integers(0, 9, 12),
                                 ["odom", "loop"] * 6)]
    kf_index = {k: i for i, k in enumerate([0, 2, 3, 5, 7, 8])}
    for cap in (16, 4):
        a = jpg.build_edges([JEdge(*r) for r in raw], kf_index, cap)
        b = tpg.build_edges([TEdge(*r) for r in raw], kf_index, cap)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_convert_round_trip_window_bank_ref():
    from ldso_tpu.config import preset
    from ldso_tpu.core import bank as jbank
    from ldso_tpu.core import window as jwin
    from ldso_tpu import tracker as jtracker

    cfg = preset("tiny")
    rng = np.random.default_rng(0)
    win = jwin.empty_window(cfg, 16, 32, np.asarray([30.0, 30.0, 15.5, 7.5], np.float32))
    bank = jbank.empty_bank(cfg.shapes.max_immature)
    n = 300
    ref = jtracker.make_tracker_ref(
        rng.random((n, 2), np.float32) * 30, rng.random(n, np.float32) + 0.1,
        rng.random(n, np.float32) * 255, rng.random(n) > 0.3, 3)
    for kind, obj in (("window", win), ("bank", bank), ("tracker_ref", ref)):
        arrays = {f: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                      else np.asarray(v)) for f, v in obj._asdict().items()}
        back = convert.to_numpy(convert.from_numpy(kind, arrays, device="cpu"))
        for f, v in arrays.items():
            vs = v if isinstance(v, tuple) else (v,)
            bs = back[f] if isinstance(back[f], tuple) else (back[f],)
            for x, y in zip(vs, bs):
                # bool stays bool, integers become int32, floats float32
                assert y.dtype == (np.bool_ if x.dtype == np.bool_ else
                                   np.int32 if np.issubdtype(x.dtype, np.integer)
                                   else np.float32), (kind, f)
                np.testing.assert_array_equal(x.astype(y.dtype), y)


def test_partition_pose_graph_copy_equals_original():
    from ldso_tpu.distributed import sharded_pgo as jspgo
    from ldso_tpu_torch.distributed import sharded_pgo as tspgo

    rng = np.random.default_rng(4)
    K = 70
    ei = np.concatenate([np.arange(1, K), rng.integers(K // 2, K, 9)]).astype(np.int32)
    ej = np.concatenate([np.arange(0, K - 1), rng.integers(0, K // 4, 9)]).astype(np.int32)
    S_meas = rng.normal(size=(len(ei), 4, 4)).astype(np.float32)
    w = rng.random(len(ei)).astype(np.float32)
    w[::7] = 0.0                                     # padding slots are skipped
    for n in (3, 4):
        a = tspgo.partition_pose_graph(K, ei, ej, S_meas, w, n)
        b = jspgo.partition_pose_graph(K, ei, ej, S_meas, w, n)
        assert a.keys() == b.keys()
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def _device_default(fn):
    return inspect.signature(fn).parameters["device"]


@pytest.mark.parametrize("name", ["loop.bow.train_vocabulary", "loop.bow.load_vocabulary_text",
                                  "convert.from_numpy"])
def test_no_cpu_default_for_a_device(name):
    # these build state a caller then uses: without a device the caller
    # would get CPU tensors it never asked for
    import importlib

    mod, fn = name.rsplit(".", 1)
    p = _device_default(getattr(importlib.import_module(f"ldso_tpu_torch.{mod}"), fn))
    assert p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is inspect.Parameter.empty


@pytest.mark.parametrize("name", ["eval.toys.make_synthetic_window", "graft_entry.entry",
                                  "graft_entry.dryrun_multichip",
                                  "distributed.sharded_pgo.shard_edges",
                                  "distributed.sharded_pgo.make_block_pgo"])
def test_new_entry_points_default_to_the_card(name):
    import importlib

    mod, fn = name.rsplit(".", 1)
    assert _device_default(getattr(importlib.import_module(f"ldso_tpu_torch.{mod}"),
                                   fn)).default == "cuda"
