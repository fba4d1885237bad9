"""Dataset readers and the CLI of the port against the JAX package's, on
fixtures written to a temporary directory by ``scripts/torch_tum_fixture.py``
(a TUM-monoVO layout: zip-packed PNGs through a real FOV lens, a gamma
response, a vignette and per-frame exposures) and by hand (KITTI, EuRoC).

Tolerances: decoded pixels, timestamps and exposures are equal; the
undistorted images agree to 1e-4 (two float32 interpolations of values up
to ~500); the CLI's ATE on the 45-frame 320x240 fixture at preset "tiny" is
below 15% of extent, as tests/test_datasets_e2e.py asks of the JAX CLI, and
within 3 points of the JAX CLI's on the same directory (the two engines
part at the frame level, ROADMAP G2)."""

import json
import logging
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))

import torch_tum_fixture as fixture  # noqa: E402
from ldso_tpu.io import datasets as jds  # noqa: E402
from ldso_tpu_torch import native  # noqa: E402
from ldso_tpu_torch.io import datasets as tds  # noqa: E402

png8 = fixture.encode_png_gray


def _png(img: np.ndarray, filters=(0,)) -> bytes:
    """8/16-bit gray or 8-bit RGB PNG with the given row filters in turn
    (the decoders must undo Sub, Up, Average and Paeth)."""
    h, w = img.shape[:2]
    nch = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    rows = rows.reshape(h, -1).astype(np.int32)
    bpp = nch * depth // 8
    raw, prev = b"", np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        f, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(ctype, data):
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, {1: 0, 3: 2}[nch], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


# ---------------------------------------------------------------- decoders


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_png_decoder_copy_equals_original(kind):
    rng = np.random.default_rng(0)
    img = {"gray8": rng.integers(0, 256, (12, 17), np.uint8),
           "gray16": rng.integers(0, 65536, (12, 17), np.uint16),
           "rgb8": rng.integers(0, 256, (12, 17, 3), np.uint8)}[kind]
    data = _png(img, filters=(0, 1, 2, 3, 4))
    got = tds._decode_png_gray(data)
    np.testing.assert_array_equal(got, jds._decode_png_gray(data))
    if kind == "gray8":
        np.testing.assert_array_equal(got, img.astype(np.float32))
    elif kind == "gray16":
        np.testing.assert_array_equal(got, img.astype(np.float32) / 256.0)


@pytest.mark.parametrize("maxval", [255, 65535])
def test_pgm_decoder_copy_equals_original(maxval):
    rng = np.random.default_rng(1)
    img = rng.integers(0, maxval + 1, (9, 14))
    body = img.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    data = f"P5\n14 9\n{maxval}\n".encode() + body
    got = tds._decode_pgm(data)
    np.testing.assert_array_equal(got, jds._decode_pgm(data))
    np.testing.assert_allclose(got, img * (255.0 / maxval), rtol=1e-6)


def test_decode_image_chain(monkeypatch, caplog):
    img = np.arange(96, dtype=np.uint8).reshape(8, 12)
    data = png8(img)
    np.testing.assert_array_equal(tds.decode_image(data), img.astype(np.float32))
    # with the native loader out, the next decoders serve the same pixels,
    # and the chain says which one is first
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", "g++ did not run: test")
    assert not native.available() and "g++" in native.unavailable_reason()
    assert tds.active_decoder() != "native"
    np.testing.assert_array_equal(tds.decode_image(data), img.astype(np.float32))
    # and with cv2 and imageio out too, the pure-numpy decoders
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    assert tds.active_decoder() == "python"
    np.testing.assert_array_equal(tds.decode_image(data), img.astype(np.float32))
    pgm = b"P5\n12 8\n255\n" + img.tobytes()
    np.testing.assert_array_equal(tds.decode_image(pgm), img.astype(np.float32))
    with pytest.raises(ValueError, match="cannot decode"):
        tds.decode_image(b"not an image", "x.bin")


def test_native_rejection_is_logged_once(monkeypatch, caplog):
    if not native.available():
        pytest.skip("native loader could not be built (no g++/libpng?)")
    monkeypatch.setattr(tds, "_warned", set())
    pgm = b"P5\n2 2\n255\n" + bytes(4)              # libpng/libjpeg reject a PGM
    with caplog.at_level(logging.WARNING, logger=tds.__name__):
        for _ in range(3):
            assert tds.decode_image(pgm, "a.pgm").shape == (2, 2)
    assert sum("native decoder rejected" in r.getMessage() for r in caplog.records) == 1


# ---------------------------------------------------------------- TUM layout


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    root, ds_gt = fixture.make_tum_fixture(str(tmp_path_factory.mktemp("tum")), n=45)
    return root, ds_gt


def test_tum_reader_matches_reference(tum_dir):
    root, _ = tum_dir
    a, b = jds.TumMonoDataset(root), tds.TumMonoDataset(root, device="cpu")
    try:
        assert a.num_frames == b.num_frames == 45
        assert a.calib.out_intr == b.calib.out_intr and b.calib.model == "fov"
        np.testing.assert_array_equal(a.intrinsics(), b.intrinsics())
        np.testing.assert_array_equal(a.pcalib.inv_response, b.pcalib.inv_response)
        np.testing.assert_array_equal(a.pcalib.vignette_inv, b.pcalib.vignette_inv)
        for i in (0, 1, 2, 7, 44):
            (ia, ta, ea), (ib, tb, eb) = a.get_image(i), b.get_image(i)
            assert (ta, ea) == (tb, eb)
            assert ib.dtype == np.float32 and ib.shape == (240, 320)
            np.testing.assert_allclose(ib, ia, atol=1e-4, rtol=0)
            assert np.isfinite(ib).all() and ib.max() > 50
    finally:
        b.close()
    assert b._zip is None and b._zpf is None


def test_tum_reader_recovers_irradiance(tmp_path):
    # tests/test_datasets_e2e.py::test_reader_recovers_irradiance on the
    # port: identity geometry, so the G⁻¹ / vignette chain alone must give
    # back the rendered irradiance times the exposure, to quantization
    from ldso_tpu_torch.io.synthetic import SyntheticDataset

    root, _ = fixture.make_tum_fixture(str(tmp_path), n=3, with_distortion=False)
    reader = tds.TumMonoDataset(root, device="cpu")
    clean = SyntheticDataset(w=400, h=300, n=3, fov_focal=0.88 * 320, seed=3,
                             scene_kind="corridor", traj_kind="forward_arc", supersample=1)
    for i in range(3):
        img, _, expo = reader.get_image(i)
        want = np.asarray(clean.get_image(i)[0], np.float64)[30:270, 40:360] * expo
        err = np.abs(img - want)
        assert np.median(err) < 1.5 and np.percentile(err, 99) < 6.0
        assert expo == pytest.approx(1.0 + 0.1 * np.sin(0.4 * i), abs=1e-5)
    reader.close()


def test_tum_folder_layout_without_calibration_files(tmp_path):
    # images/ instead of images.zip, no times.txt / pcalib.txt / vignette.png
    rng = np.random.default_rng(2)
    (tmp_path / "images").mkdir()
    imgs = [rng.integers(0, 256, (48, 64), np.uint8) for _ in range(3)]
    for i, img in enumerate(imgs):
        (tmp_path / "images" / f"{i:05d}.png").write_bytes(png8(img))
    (tmp_path / "camera.txt").write_text("40 40 31.5 23.5\n64 48\nfull\n64 48\n")
    a, b = jds.TumMonoDataset(str(tmp_path)), tds.TumMonoDataset(str(tmp_path), device="cpu")
    for i in range(3):
        (ia, ta, ea), (ib, tb, eb) = a.get_image(i), b.get_image(i)
        assert (ta, ea) == (tb, eb) == (0.05 * i, 1.0)
        np.testing.assert_array_equal(ib, imgs[i].astype(np.float32))
        np.testing.assert_array_equal(ia, ib)
    b.close()


# ---------------------------------------------------------------- KITTI, EuRoC


def test_kitti_layout(tmp_path):
    rng = np.random.default_rng(2)
    seq = tmp_path / "00"
    (seq / "image_0").mkdir(parents=True)
    imgs = [rng.integers(0, 256, (32, 48), np.uint8) for _ in range(6)]
    for i, img in enumerate(imgs):
        (seq / "image_0" / f"{i:06d}.png").write_bytes(png8(img))
    np.savetxt(seq / "times.txt", np.arange(6) * 0.1)
    (seq / "calib.txt").write_text(
        "P0: 40.0 0.0 24.0 0.0 0.0 40.0 16.0 0.0 0.0 0.0 1.0 0.0\n")
    a, b = jds.KittiDataset(str(seq)), tds.KittiDataset(str(seq), device="cpu")
    assert b.num_frames == 6 and b._remap is None
    np.testing.assert_array_equal(a.intrinsics(), b.intrinsics())
    np.testing.assert_array_equal(b.intrinsics(), [40.0, 40.0, 24.0, 16.0])
    for i in range(6):
        (ia, ta, ea), (ib, tb, eb) = a.get_image(i), b.get_image(i)
        assert (ta, ea) == (tb, eb) and eb == 1.0
        np.testing.assert_array_equal(ib, imgs[i].astype(np.float32))
        np.testing.assert_array_equal(ia, ib)
    # a frame asked for again (out of order) is decoded on the feed thread
    np.testing.assert_array_equal(b.get_image(2)[0], imgs[2].astype(np.float32))
    if native.available():
        assert b._pf is not None, "native prefetcher should be active"
    b.close()
    assert b._pf is None


YAML_OK = """
cam0:
  T_BS:
    data: [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]
rate_hz: 20
resolution: [64, 48]
camera_model: pinhole
intrinsics: [40.0, 40.0, 31.5, 23.5]
distortion_model: radial-tangential
distortion_coefficients: [-0.28, 0.07, 0.0002, 0.00002]
"""


def _euroc_fixture(tmp_path, yaml_text):
    cam = tmp_path / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = ["#timestamp [ns],filename"]
    for i in range(2):
        name = f"{1403636579763555584 + i * 50000000}.png"
        (cam / "data" / name).write_bytes(png8(rng.integers(0, 256, (48, 64), np.uint8)))
        rows.append(f"{name[:-4]},{name}")
    (cam / "data.csv").write_text("\n".join(rows) + "\n")
    if yaml_text is not None:
        (cam / "sensor.yaml").write_text(yaml_text)
    return str(tmp_path)


def test_euroc_valid_yaml_radtan_crop(tmp_path):
    root = _euroc_fixture(tmp_path, YAML_OK)
    a, b = jds.EurocDataset(root), tds.EurocDataset(root, device="cpu")
    assert b.calib.model == "radtan"
    assert b.calib.in_intr == (40.0, 40.0, 31.5, 23.5)
    assert b.calib.in_size == (64, 48)
    assert b.calib.out_intr == a.calib.out_intr != b.calib.in_intr
    assert 10.0 < b.calib.out_intr[0] < 200.0
    for i in range(2):
        (ia, ta, ea), (ib, tb, eb) = a.get_image(i), b.get_image(i)
        assert (ta, ea) == (tb, eb)
        assert ib.shape == (48, 64) and np.isfinite(ib).all()
        np.testing.assert_allclose(ib, ia, atol=1e-4, rtol=0)
    b.close()


@pytest.mark.parametrize("old,new,match", [
    ("intrinsics:", "intrinsics_gone:", "intrinsics"),
    ("[-0.28, 0.07, 0.0002, 0.00002]", "[-0.28, 0.07]", "distortion_coefficients"),
    ("radial-tangential", "equidistant", "distortion model"),
], ids=["missing_field", "wrong_arity", "unsupported_model"])
def test_euroc_strict_yaml_raises(tmp_path, old, new, match):
    root = _euroc_fixture(tmp_path, YAML_OK.replace(old, new))
    with pytest.raises(ValueError, match=match):
        tds.EurocDataset(root, device="cpu")
    with pytest.raises(ValueError, match=match):
        jds.EurocDataset(root)


def test_euroc_missing_yaml_takes_the_standard_calibration(tmp_path):
    path = str(tmp_path / "mav0" / "cam0" / "sensor.yaml")
    assert tds.EurocDataset._parse_sensor_yaml(path) == jds.EurocDataset._parse_sensor_yaml(path)
    assert tds.EurocDataset._parse_sensor_yaml(path)[2] == (752, 480)


def test_open_dataset_kinds(tmp_path, tum_dir):
    from ldso_tpu_torch.io.synthetic import SyntheticDataset

    assert isinstance(tds.open_dataset("synthetic", ""), SyntheticDataset)
    ds = tds.open_dataset("tum", tum_dir[0], device="cpu")
    assert isinstance(ds, tds.TumMonoDataset) and ds.device == torch.device("cpu")
    ds.close()
    assert isinstance(tds.open_dataset("euroc", _euroc_fixture(tmp_path, YAML_OK), "cpu"),
                      tds.EurocDataset)
    with pytest.raises(ValueError, match="unknown dataset kind"):
        tds.open_dataset("nope", "")


# ---------------------------------------------------------------- the CLI


def _ate_pct(traj_file, ds_gt):
    from ldso_tpu_torch.eval.ate import ate_rmse, read_tum_trajectory

    ts, pos, _ = read_tum_trajectory(traj_file)
    assert np.isfinite(pos).all()
    gt_c = np.stack([ds_gt.poses_w_c[int(round(t / 0.05))][:3, 3] for t in ts])
    rmse, _ = ate_rmse(pos, gt_c, with_scale=True)
    return 100.0 * rmse / np.linalg.norm(gt_c.max(0) - gt_c.min(0)), len(ts)


@pytest.fixture
def single_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_runs_tum_fixture_end_to_end(tum_dir, tmp_path, capsys, single_torch_thread):
    import threading

    from ldso_tpu import cli as jcli
    from ldso_tpu_torch import cli as tcli

    root, ds_gt = tum_dir
    out, metrics, viz = (str(tmp_path / n) for n in ("traj.txt", "metrics.jsonl", "viz"))
    before = set(threading.enumerate())
    rc = tcli.main(["run", "--dataset", "tum", "--path", root, "--preset", "tiny",
                    "--device", "cpu", "--loop-closing", "0", "--output", out,
                    "--metrics", metrics, "--viz", viz])
    assert rc == 0
    assert set(threading.enumerate()) <= before, "the CLI left a thread running"
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 45 and summary["skipped"] == 0 and not summary["lost"]
    ate, n = _ate_pct(out, ds_gt)
    assert n >= 35, f"only {n} poses exported"
    assert ate < 15.0, f"ATE {ate:.2f}% of extent"
    # one metrics line per tracked frame (the bootstrap frames write none,
    # as in the reference), frame ids consecutive up to the last frame
    rows = [json.loads(line) for line in open(metrics)]
    assert [r["frame"] for r in rows] == list(range(45 - len(rows), 45)) and len(rows) >= 30
    assert all("rmse" in r and "status" not in r for r in rows)
    # --metrics turns the span recorder on: each row has its frame's spans,
    # a keyframe's row its keyframe path and BA's counters; off again after
    from ldso_tpu_torch import telemetry

    assert not telemetry.enabled()
    assert all({"add_frame", "wait.upload", "fused_step", "pyramid", "predict", "track",
                "trace"} <= set(r["ms"]) for r in rows)
    assert all(r["ms"]["add_frame"] >= r["ms"]["fused_step"] > 0 for r in rows)
    kf_rows = [r for r in rows if "kf_id" in r]
    assert kf_rows and all({"kf_path", "activate", "seed_select", "ba", "ba.solve",
                            "tracker_ref", "seed_patch", "kf_finish"} <= set(r["ms"])
                           and r["counts"]["ba.trials"] >= 1 for r in kf_rows)
    assert os.path.isfile(os.path.join(viz, "map.ply"))
    with open(os.path.join(viz, "map.ply")) as f:
        n_vertex = int(next(line for line in f if line.startswith("element vertex")).split()[-1])
    assert n_vertex > 0

    jout = str(tmp_path / "traj_jax.txt")
    assert jcli.main(["run", "--dataset", "tum", "--path", root, "--preset", "tiny",
                      "--loop-closing", "0", "--output", jout]) == 0
    jate, jn = _ate_pct(jout, ds_gt)
    assert abs(n - jn) <= 1
    assert abs(ate - jate) < 3.0, f"port {ate:.2f}% against JAX {jate:.2f}% of extent"


def test_cli_flags_and_lost_frame_still_joins_threads(tmp_path, capsys, monkeypatch,
                                                      single_torch_thread):
    # --frames / --start / --reverse / --async on the synthetic dataset; a
    # frame reported lost with --relocalize 0 ends the feed, and the
    # mapping thread and the loop worker are joined all the same
    import threading

    from ldso_tpu_torch import cli as tcli
    from ldso_tpu_torch.io import synthetic
    from ldso_tpu_torch.system import FullSystem

    small = lambda: synthetic.SyntheticDataset(w=160, h=120, n=12, seed=0,  # noqa: E731
                                               traj_kind="forward_arc", supersample=1)
    monkeypatch.setattr(tds, "open_dataset", lambda kind, path, device="cuda": small())
    fed = []
    add_frame = FullSystem.add_frame

    def add_then_lose(self, img, ts=None, exposure=1.0):
        st = add_frame(self, img, ts, exposure)
        fed.append(round(ts / 0.05))
        return dict(status="lost", frame_id=st["frame_id"]) if len(fed) == 6 else st

    monkeypatch.setattr(FullSystem, "add_frame", add_then_lose)
    before = set(threading.enumerate())
    rc = tcli.main(["run", "--dataset", "synthetic", "--preset", "tiny", "--device", "cpu",
                    "--start", "2", "--frames", "9", "--reverse", "--async", "1",
                    "--pipeline-depth", "2", "--relocalize", "0", "--seed", "5",
                    "--output", str(tmp_path / "t.txt")])
    assert rc == 0
    assert fed == [10, 9, 8, 7, 6, 5]
    assert set(threading.enumerate()) <= before, "a worker thread outlived the run"
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 6


def test_cli_help_runs_without_jax():
    import subprocess

    code = ("import sys\n"
            "from ldso_tpu_torch import cli\n"
            "try:\n    cli.main(['run', '--help'])\n"
            "except SystemExit as e:\n    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ldso_tpu'))\n"
            "print(bad); sys.exit(1 if bad or rc else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "--device" in out.stdout and "--playback-speed" in out.stdout
