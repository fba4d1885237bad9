"""ctypes bindings for the native image decode + prefetch pipeline.

Port of ``ldso_tpu/native/__init__.py``. The host-side frame IO stays
native C++ (``loader.cc``, a byte-for-byte copy of the reference's):
libpng/libjpeg decode plus a pthread worker pool that decodes frames AHEAD
of the tracking loop into a bounded in-order buffer, overlapping host IO
with device compute.

The shared library is built lazily on first use with the system g++ (plain
C ABI + ctypes) into ``.build/ldso_tpu_torch/`` at the root of the
checkout, beside the CUDA kernel's library; the file name carries a hash
of the source, the flags and the host CPU's identity (``-march=native``
code from another machine is never loaded). Every consumer must handle :func:`available`
returning False (a machine without a toolchain or without the libpng /
libjpeg headers falls back to the pure-Python decoders in
``ldso_tpu_torch/io/datasets.py``); :func:`unavailable_reason` then says
why, and the failure is logged once at warning level.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_LOG = logging.getLogger(__name__)
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "loader.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".build", "ldso_tpu_torch")
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_LIBS = ["-lpng", "-ljpeg", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failure: Optional[str] = None      # why the native path is out, once known


def _fail(reason: str) -> None:
    global _failure
    _failure = reason
    _LOG.warning("native image loader unavailable: %s", reason)


def _host_cpu() -> str:
    """Architecture and instruction-set flags of this host: what
    ``-march=native`` compiles for."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.split(":")[0].strip().lower() in ("flags", "features"):
                    return ident + " " + " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return ident + " " + platform.processor()


def _build() -> Optional[str]:
    """Compile loader.cc (unless already built from the same source and
    flags on a host with the same CPU features) and return the library's path, or None with the reason kept."""
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(_FLAGS + _LIBS).encode()
                         + _host_cpu().encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libldso_native_{tag}.so")
    if os.path.isfile(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, *_LIBS, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        _fail(f"g++ did not run: {e}")
        return None
    if r.returncode != 0:
        _fail("build failed:\n" + r.stderr[-2000:].strip())
        return None
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None or _failure is not None:
            return _lib
        lib = None
        for attempt in (0, 1):
            so = _build()
            if so is None:
                return None
            try:
                lib = ctypes.CDLL(so)
                break
            except OSError as e:
                # a library that another machine left in a copied build
                # directory does not load here: build it again, once
                os.remove(so)
                if attempt:
                    _fail(f"could not load {os.path.basename(so)}: {e}")
                    return None
        lib.ldso_decode_gray.restype = ctypes.c_int
        lib.ldso_decode_gray.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ldso_probe.restype = ctypes.c_int
        lib.ldso_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ldso_prefetcher_create.restype = ctypes.c_void_p
        lib.ldso_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.ldso_prefetcher_get.restype = ctypes.c_int
        lib.ldso_prefetcher_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ldso_prefetcher_destroy.restype = None
        lib.ldso_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True if the native loader is built (building it if needed)."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why :func:`available` is False (compiler missing, build or link
    error); None while the loader works or has not been tried."""
    return _failure


_MAX_PIXELS = 4096 * 3072


def decode_gray(data: bytes) -> Optional[np.ndarray]:
    """Decode PNG/JPEG bytes to f32 [H, W] in [0, 255]; None on failure."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(_MAX_PIXELS, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.ldso_decode_gray(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return out[: w.value * h.value].reshape(h.value, w.value).copy()


class Prefetcher:
    """In-order frame prefetcher over a list of image paths.

    Worker threads decode up to `ahead` frames past the last-consumed
    index; :meth:`get` blocks until frame `idx` is ready. Consumption
    must be in order (the SLAM frame loop is)."""

    def __init__(self, paths: Sequence[str], n_threads: int = 3,
                 ahead: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._h = lib.ldso_prefetcher_create(arr, len(self._paths),
                                             n_threads, ahead)
        self._n = len(paths)
        self._buf = np.empty(_MAX_PIXELS, np.float32)

    def __len__(self) -> int:
        return self._n

    def get(self, idx: int) -> np.ndarray:
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.ldso_prefetcher_get(
            self._h, idx,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._buf.size, ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise RuntimeError(f"prefetcher_get({idx}) failed rc={rc}")
        return self._buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ldso_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
