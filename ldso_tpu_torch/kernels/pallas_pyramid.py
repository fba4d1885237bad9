"""CUDA kernel for the pyramid build (counterpart of the JAX package's
``kernels/pallas_pyramid.py``, whose Pallas ``_level_kernel`` it replaces
on an NVIDIA Hopper card).

The kernel source is ``ldso_tpu_torch/csrc/pyramid.cu``: ONE launch builds
every level of every frame of a ``[B, H, W]`` batch. A thread block owns
a 64x32 tile of level 0 with a recomputed halo, pools the higher levels
in shared memory, and writes the interleaved (I, dx, dy) stacks and the
squared gradients as 16-byte stores (see the note at the top of the
source). It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, into
``.build/ldso_tpu_torch/`` at the root of the checkout, and bound with
``ctypes``. Nothing is compiled or loaded at import.

``LAUNCHES`` counts kernel launches (one per call, whatever the batch);
it is incremented only where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "pyramid.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".build", "ldso_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()      # tracking and mapping threads both count
MAX_LEVELS = 6                        # kMaxLevels of the source


def reset_launches() -> None:
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the pyramid kernel needs the CUDA toolkit")


def build() -> str:
    """Compile csrc/pyramid.cu (if not already built from the same source)
    and return the library path. The file name carries a hash of the
    source and flags, so an edited source is never served stale."""
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libldso_pyramid_{tag}.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC], check=True)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ldso_pyramid_u8, lib.ldso_pyramid_f32):
        # in, B, H, W, L, out3[L], gsq[L], stream
        fn.argtypes = [p, i, i, i, i, ctypes.POINTER(p), ctypes.POINTER(p), p]
        fn.restype = i
    return lib


def build_pyramid_cuda(img: torch.Tensor, levels: int
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """img [H, W] or [B, H, W], uint8 or float32, on a CUDA device ->
    ([L x (..., H_l, W_l, 3)] (I, dx, dy) stacks, [L x (..., H_l, W_l)]
    grad-sq), with the leading batch dimension of ``img``. One launch."""
    if img.device.type != "cuda":
        raise ValueError(f"build_pyramid_cuda needs a CUDA tensor, got {img.device}")
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"pyramid kernel takes uint8 or float32, got {img.dtype}")
    if img.ndim not in (2, 3) or not img.is_contiguous():
        raise ValueError("pyramid kernel takes a contiguous [H, W] or [B, H, W] image")
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"pyramid kernel builds 1..{MAX_LEVELS} levels, got {levels}")
    lead = tuple(img.shape[:-2])
    b = lead[0] if lead else 1
    h, w = img.shape[-2:]
    m = 1 << (levels - 1)
    if b < 1 or h < m or w < m or h % m or w % m:
        raise ValueError(f"image batch {tuple(img.shape)} not divisible at {levels} levels")
    global LAUNCHES
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=img.device)
    pyr = [torch.empty(lead + (h >> l, w >> l, 3), **f32) for l in range(levels)]
    gsq = [torch.empty(lead + (h >> l, w >> l), **f32) for l in range(levels)]
    ptrs = ctypes.c_void_p * levels
    fn = lib.ldso_pyramid_u8 if img.dtype == torch.uint8 else lib.ldso_pyramid_f32
    with torch.cuda.device(img.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        # the foreign call releases the interpreter lock; the count is
        # updated outside it
        err = fn(img.data_ptr(), b, h, w, levels, ptrs(*(t.data_ptr() for t in pyr)),
                 ptrs(*(t.data_ptr() for t in gsq)), stream)
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"pyramid kernel launch failed: cudaError {err}")
    return pyr, gsq
