"""Dataset readers: TUM-Mono, KITTI odometry, EuRoC MAV.

Port of ``ldso_tpu/io/datasets.py``: each reader yields undistorted,
photometrically corrected float images plus timestamp and exposure,
through the shared geometric (``ldso_tpu_torch/cameras.py``) and
photometric (``ldso_tpu_torch/io/photometric.py``) calibration chain. A
reader takes the torch device that chain runs on (default: the CUDA
card): the decoded frame goes up once, response, vignette and lens are
undone there in one pass, and the result comes back as numpy, because the
reader protocol below is shared with ``FullSystem.add_frame``. Decoding
(numpy and the native loader) stays on the host; the decode threads touch
no torch.

Image decode prefers the native C++ loader (``ldso_tpu_torch/native``),
then cv2 / imageio when present, then the pure-numpy PNG/PGM decoders
below (copied from the reference, as is the strict ``sensor.yaml`` parser;
``tests/test_torch_package.py`` pins the copies). The order is the
reference's; unlike it, a native path that is out says why, once, at
warning level.

Reader protocol (shared with io/synthetic.SyntheticDataset):
    num_frames: int
    intrinsics() -> np [4]
    get_image(i) -> (img f32 [H, W], timestamp: float, exposure: float)
"""

from __future__ import annotations

import logging
import os
import struct
import zipfile
import zlib
from typing import List, Optional

import numpy as np
import torch

from ldso_tpu_torch import cameras, native
from ldso_tpu_torch.io import photometric as photo
from ldso_tpu_torch.kernels.interp import remap_image

_LOG = logging.getLogger(__name__)
_warned: set = set()          # warnings of the decoder chain already given


def _warn_once(key: str, msg: str, *args) -> None:
    if key not in _warned:
        _warned.add(key)
        _LOG.warning(msg, *args)


# ---------------------------------------------------------------------------
# Minimal image decoding (PNG grayscale / PGM) without hard deps
# ---------------------------------------------------------------------------


def _decode_png_gray(data: bytes) -> np.ndarray:
    """Pure-numpy grayscale (or RGB→gray) 8/16-bit PNG decoder — the
    fallback when imageio/cv2 are unavailable."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    width = height = bitdepth = colortype = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        if ctype == b"IHDR":
            width, height, bitdepth, colortype = struct.unpack(">IIBB", chunk[:10])
            assert chunk[10] == 0 and chunk[11] == 0 and chunk[12] == 0, \
                "unsupported PNG (compression/filter/interlace)"
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[colortype]
    bpp_bytes = (bitdepth // 8) * nch
    stride = width * bpp_bytes
    img = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        f = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if f == 0:
            pass
        elif f == 1:  # Sub
            for x in range(bpp_bytes, stride):
                line[x] = (line[x] + line[x - bpp_bytes]) & 0xFF
        elif f == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif f == 3:  # Average
            for x in range(stride):
                a = line[x - bpp_bytes] if x >= bpp_bytes else 0
                line[x] = (line[x] + ((int(a) + int(prev[x])) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            for x in range(stride):
                a = int(line[x - bpp_bytes]) if x >= bpp_bytes else 0
                b = int(prev[x])
                c = int(prev[x - bpp_bytes]) if x >= bpp_bytes else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (line[x] + pr) & 0xFF
        else:
            raise ValueError(f"PNG filter {f}")
        img[y] = line
        prev = line
    if bitdepth == 16:
        arr = img.reshape(height, width, nch, 2)
        out = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
        out = out.astype(np.float32) / 256.0
    else:
        out = img.reshape(height, width, nch).astype(np.float32)
    if nch >= 3:
        out = 0.299 * out[..., 0] + 0.587 * out[..., 1] + 0.114 * out[..., 2]
    else:
        out = out[..., 0]
    return out


def active_decoder() -> str:
    """The first decoder of :func:`decode_image`'s chain that this machine
    has: ``native``, ``cv2``, ``imageio`` or ``python``."""
    if native.available():
        return "native"
    for mod in ("cv2", "imageio.v3"):
        try:
            __import__(mod)
            return mod.split(".")[0]
        except ImportError:
            pass
    return "python"


def decode_image(data: bytes, name: str = "") -> np.ndarray:
    """Decode to grayscale f32 [H, W] in [0, 255].

    Prefers the native C++ decoder (ldso_tpu_torch/native: libpng/libjpeg
    via ctypes), then cv2/imageio, then the pure-numpy fallback. A native
    decoder that could not be built has logged its reason; one that is
    built and rejects this image is logged here, once."""
    img = native.decode_gray(data)
    if img is not None:
        return img
    if native.available():
        _warn_once("decode", "native decoder rejected image %r; trying the "
                   "other decoders (logged once)", name)
    try:
        import cv2  # type: ignore

        buf = np.frombuffer(data, np.uint8)
        img = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
        if img is not None:
            return img.astype(np.float32)
    except ImportError:
        pass
    try:
        import imageio.v3 as iio  # type: ignore

        img = iio.imread(data)
        img = np.asarray(img, np.float32)
        if img.ndim == 3:
            img = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
        return img
    except ImportError:
        pass
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return _decode_png_gray(data)
    if data[:2] in (b"P5", b"P2"):  # PGM
        return _decode_pgm(data)
    raise ValueError(f"cannot decode image {name!r}: no decoder available")


def _decode_pgm(data: bytes) -> np.ndarray:
    parts = data.split(maxsplit=4)
    magic, w, h, maxval = parts[0], int(parts[1]), int(parts[2]), int(parts[3])
    if magic == b"P5":
        raw = parts[4] if len(parts) > 4 else b""
        dt = np.uint8 if maxval < 256 else ">u2"
        img = np.frombuffer(raw[: w * h * np.dtype(dt).itemsize], dt)
        return img.reshape(h, w).astype(np.float32) * (255.0 / maxval)
    vals = np.array(parts[4].split(), dtype=np.float64)  # pragma: no cover
    return vals.reshape(h, w).astype(np.float32) * (255.0 / maxval)


# ---------------------------------------------------------------------------
# Base reader with shared undistortion + photometric pipeline
# ---------------------------------------------------------------------------


class _BaseReader:
    """Applies photometric correction (inverse response, vignette) and
    geometric undistortion (remap) to raw frames on ``device`` (reference:
    the Undistort + PhotometricUndistorter chain in every runner). The
    remap grid, the LUT and the vignette are put on the device once."""

    def __init__(self, calib: Optional[cameras.CameraCalib],
                 pcalib: Optional[photo.PhotometricCalib], device="cuda"):
        self.calib = calib
        self.pcalib = pcalib or photo.PhotometricCalib.identity()
        self.device = torch.device(device)
        self._remap = None
        identity = (calib.model == "pinhole"
                    and calib.in_size == calib.out_size
                    and tuple(calib.in_intr) == tuple(calib.out_intr))
        if not identity:
            self._remap = torch.as_tensor(cameras.make_remap(calib), device=self.device)
        self._photo_fn = photo.make_photometric_fn(self.pcalib, self.device)

    def intrinsics(self) -> np.ndarray:
        return np.asarray(self.calib.out_intr, np.float32)

    def _undistort(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw frame on the device -> irradiance through the ideal pinhole."""
        img = self._photo_fn(raw)
        if self._remap is not None:
            img = remap_image(img, self._remap)
        return img

    def _process(self, raw: np.ndarray) -> np.ndarray:
        out = self._undistort(torch.from_numpy(np.ascontiguousarray(raw)).to(self.device))
        return out.to(torch.float32).cpu().numpy()

    def close(self):
        """Stop the reader's prefetch threads and close its files."""


class _FilePrefetchMixin:
    """Readers over plain image files pull frames through the native
    threaded prefetcher when available (ldso_tpu_torch/native), so
    host-side decode overlaps device compute."""

    def _raw_frame(self, i: int) -> np.ndarray:
        if not hasattr(self, "_pf"):
            self._pf = None
            self._pf_next = 0
            if native.available():
                self._pf = native.Prefetcher(self._names)
        if self._pf is not None and i >= self._pf_next:
            self._pf_next = i + 1
            try:
                return self._pf.get(i)
            except RuntimeError as e:
                _warn_once("prefetch", "native prefetcher failed (%s); decoding "
                           "on the feed thread (logged once)", e)
        with open(self._names[i], "rb") as f:
            return decode_image(f.read(), self._names[i])

    def close(self):
        if getattr(self, "_pf", None) is not None:
            self._pf.close()
            self._pf = None


class _ZipPrefetcher:
    """Threaded look-ahead decode for zip-packed sequences: the feed
    thread asks for frame i while workers read+decode frames i+1..i+K in
    the background (the zip handle is guarded; decode runs unlocked).
    This is the TUM-zip analog of the native file prefetcher — the
    reference decodes synchronously on its feed thread
    (examples/run_dso_tum_mono.cc main loop)."""

    def __init__(self, zf: zipfile.ZipFile, names: List[str], depth: int = 4):
        import concurrent.futures
        import threading

        self._zf = zf
        self._names = names
        self._depth = depth
        self._lock = threading.Lock()
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        self._futures: dict = {}

    def _load(self, i: int) -> np.ndarray:
        with self._lock:
            data = self._zf.read(self._names[i])
        return decode_image(data, self._names[i])

    def get(self, i: int) -> np.ndarray:
        fut = self._futures.pop(i, None)
        # schedule look-ahead
        for j in range(i + 1, min(i + 1 + self._depth, len(self._names))):
            if j not in self._futures:
                self._futures[j] = self._pool.submit(self._load, j)
        if fut is not None:
            return fut.result()
        return self._load(i)

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._futures.clear()


class TumMonoDataset(_BaseReader):
    """TUM monoVO layout: images.zip (or images/), times.txt with
    exposures, camera.txt, pcalib.txt, vignette.png
    (reference: examples/run_dso_tum_mono.cc)."""

    def __init__(self, path: str, device="cuda"):
        self.path = path
        self._zip = None
        self._zpf = None
        names: List[str] = []
        if os.path.isfile(os.path.join(path, "images.zip")):
            self._zip = zipfile.ZipFile(os.path.join(path, "images.zip"))
            names = sorted(n for n in self._zip.namelist()
                           if n.lower().endswith((".jpg", ".png")))
        else:
            d = os.path.join(path, "images")
            names = sorted(os.path.join(d, n) for n in os.listdir(d)
                           if n.lower().endswith((".jpg", ".png")))
        self._names = names

        # times.txt: "id timestamp exposure"
        self._ts = np.arange(len(names), dtype=np.float64) * 0.05
        self._exp = np.ones(len(names))
        tf = os.path.join(path, "times.txt")
        if os.path.isfile(tf):
            rows = np.loadtxt(tf, usecols=None, ndmin=2)
            self._ts = rows[:, 1].astype(np.float64)
            if rows.shape[1] >= 3:
                self._exp = rows[:, 2].astype(np.float64)

        with open(os.path.join(path, "camera.txt")) as f:
            calib = cameras.parse_calib_text(f.read())
        pfile = os.path.join(path, "pcalib.txt")
        vfile = os.path.join(path, "vignette.png")
        resp = None
        vig = None
        if os.path.isfile(pfile):
            with open(pfile) as f:
                resp = photo.parse_pcalib_text(f.read())
        if os.path.isfile(vfile):
            with open(vfile, "rb") as f:
                vig = decode_image(f.read(), "vignette.png")
            vig = vig / vig.max()
        pc = photo.PhotometricCalib.from_arrays(resp, vig)
        super().__init__(calib, pc, device)

    @property
    def num_frames(self) -> int:
        return len(self._names)

    def get_image(self, i: int):
        if self._zip is not None:
            if self._zpf is None:
                self._zpf = _ZipPrefetcher(self._zip, self._names)
            raw = self._zpf.get(i)
        else:
            with open(self._names[i], "rb") as f:
                raw = decode_image(f.read(), self._names[i])
        return self._process(raw), float(self._ts[i]), float(self._exp[i])

    def close(self):
        if self._zpf is not None:
            self._zpf.close()
            self._zpf = None
        if self._zip is not None:
            self._zip.close()
            self._zip = None


class KittiDataset(_FilePrefetchMixin, _BaseReader):
    """KITTI odometry grayscale: sequences/NN/image_0/*.png + times.txt +
    calib.txt (reference: examples/run_dso_kitti.cc). KITTI images are
    pre-rectified → pinhole passthrough, no photometric calib."""

    def __init__(self, seq_path: str, device="cuda"):
        self.path = seq_path
        d = os.path.join(seq_path, "image_0")
        self._names = sorted(os.path.join(d, n) for n in os.listdir(d)
                             if n.endswith(".png"))
        self._ts = np.loadtxt(os.path.join(seq_path, "times.txt"))
        # calib.txt: P0 row-major 3x4
        with open(os.path.join(seq_path, "calib.txt")) as f:
            for line in f:
                if line.startswith("P0"):
                    v = np.array(line.split(":", 1)[1].split(), dtype=np.float64)
                    fx, cx, fy, cy = v[0], v[2], v[5], v[6]
                    break
        with open(self._names[0], "rb") as f:
            img0 = decode_image(f.read())
        h, w = img0.shape
        calib = cameras.pinhole_calib(w, h, fx, fy, cx, cy)
        super().__init__(calib, None, device)

    @property
    def num_frames(self) -> int:
        return len(self._names)

    def get_image(self, i: int):
        raw = self._raw_frame(i)
        return self._process(raw), float(self._ts[i]), 1.0


class EurocDataset(_FilePrefetchMixin, _BaseReader):
    """EuRoC MAV: mav0/cam0/data/*.png + data.csv (timestamps ns)
    (reference: examples/run_dso_euroc.cc), radtan intrinsics from
    sensor.yaml, undistorted in crop mode."""

    def __init__(self, path: str, device="cuda"):
        cam = os.path.join(path, "mav0", "cam0")
        d = os.path.join(cam, "data")
        rows = []
        with open(os.path.join(cam, "data.csv")) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                ts_s, name = line.strip().split(",")[:2]
                rows.append((int(ts_s), name))
        rows.sort()
        self._ts = np.asarray([r[0] for r in rows], np.float64) * 1e-9
        self._names = [os.path.join(d, r[1]) for r in rows]

        intr, dist, size = self._parse_sensor_yaml(os.path.join(cam, "sensor.yaml"))
        w, h = size
        out_intr = cameras.find_crop_intrinsics(
            "radtan", (w, h), tuple(intr), tuple(dist), (w, h))
        calib = cameras.CameraCalib(
            model="radtan", in_size=(w, h), in_intr=tuple(intr),
            dist_params=tuple(dist), out_size=(w, h), out_intr=out_intr)
        super().__init__(calib, None, device)

    @staticmethod
    def _parse_sensor_yaml(path: str):
        """Strict sensor.yaml parse. A missing file falls back to the
        standard EuRoC cam0 calibration (all public sequences share it);
        a PRESENT file that fails to parse raises — silently tracking
        with wrong intrinsics corrupts every downstream estimate
        (round-2 finding: regex-with-baked-defaults)."""
        if not os.path.isfile(path):
            return ([458.654, 457.296, 367.215, 248.375],
                    [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
                    (752, 480))
        import re

        text = open(path).read()

        def field(name, n, cast):
            m = re.search(name + r":\s*\[([^\]]+)\]", text)
            if not m:
                raise ValueError(
                    f"{path}: required field '{name}' not found — refusing "
                    f"to fall back to baked-in EuRoC defaults")
            vals = [cast(x) for x in m.group(1).split(",")]
            if len(vals) != n:
                raise ValueError(f"{path}: '{name}' has {len(vals)} values, "
                                 f"expected {n}")
            return vals

        model = re.search(r"distortion_model:\s*(\S+)", text)
        if model and model.group(1).strip() not in ("radtan",
                                                    "radial-tangential"):
            raise ValueError(f"{path}: unsupported distortion model "
                             f"{model.group(1)!r} (expected radtan)")
        intr = field("intrinsics", 4, float)
        dist = field("distortion_coefficients", 4, float)
        size = tuple(field("resolution", 2, int))
        return intr, dist, size

    @property
    def num_frames(self) -> int:
        return len(self._names)

    def get_image(self, i: int):
        raw = self._raw_frame(i)
        return self._process(raw), float(self._ts[i]), 1.0


def open_dataset(kind: str, path: str, device="cuda"):
    """Factory matching the reference runners (`run_dso_{tum_mono,kitti,
    euroc}`); kind="synthetic" uses the built-in renderer, which needs no
    device."""
    if kind == "tum":
        return TumMonoDataset(path, device)
    if kind == "kitti":
        return KittiDataset(path, device)
    if kind == "euroc":
        return EurocDataset(path, device)
    if kind == "synthetic":
        from ldso_tpu_torch.io.synthetic import SyntheticDataset

        return SyntheticDataset()
    raise ValueError(f"unknown dataset kind {kind!r}")
