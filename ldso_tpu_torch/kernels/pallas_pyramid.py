"""CUDA kernel for the pyramid level build (counterpart of the JAX
package's ``kernels/pallas_pyramid.py``, whose Pallas ``_level_kernel``
it replaces on an NVIDIA Hopper card).

The kernel source is ``ldso_tpu_torch/csrc/pyramid.cu``: one thread per
pixel writes the interleaved (I, dx, dy) stack, the squared gradient and
the next level's intensity (see the note at the top of the source). It
is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use, into ``.build/ldso_tpu_torch/`` at the
root of the checkout, and bound with ``ctypes``. Nothing is compiled or
loaded at import.

``LAUNCHES`` counts kernel launches (one per pyramid level); it is
incremented only where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import List, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "pyramid.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".build", "ldso_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
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
    lib.ldso_pyramid_level_u8.argtypes = [p, i, i, p, p, p, p]
    lib.ldso_pyramid_level_u8.restype = i
    lib.ldso_pyramid_level_f32.argtypes = [p, i, i, i, p, p, p, i, p]
    lib.ldso_pyramid_level_f32.restype = i
    return lib


def _check(err: int, level: int) -> None:
    if err != 0:
        raise RuntimeError(f"pyramid kernel launch failed at level {level}: "
                           f"cudaError {err}")


def build_pyramid_cuda(img: torch.Tensor, levels: int
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """img [H, W] uint8 or float32 on a CUDA device ->
    ([L x (H_l, W_l, 3)] (I, dx, dy) stacks, [L x (H_l, W_l)] grad-sq)."""
    if img.device.type != "cuda":
        raise ValueError(f"build_pyramid_cuda needs a CUDA tensor, got {img.device}")
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"pyramid kernel takes uint8 or float32, got {img.dtype}")
    if img.ndim != 2 or not img.is_contiguous():
        raise ValueError("pyramid kernel takes a contiguous [H, W] image")
    h, w = img.shape
    if h % (1 << (levels - 1)) or w % (1 << (levels - 1)):
        raise ValueError(f"image {w}x{h} not divisible at {levels} levels")
    global LAUNCHES
    lib = _lib()
    stream = ctypes.c_void_p(torch.cuda.current_stream(img.device).cuda_stream)
    pyr = [torch.empty((h >> l, w >> l, 3), dtype=torch.float32, device=img.device)
           for l in range(levels)]
    gsq = [torch.empty((h >> l, w >> l), dtype=torch.float32, device=img.device)
           for l in range(levels)]
    for l in range(levels):
        nxt = pyr[l + 1].data_ptr() if l + 1 < levels else None
        hl, wl = h >> l, w >> l
        if l == 0 and img.dtype == torch.uint8:
            err = lib.ldso_pyramid_level_u8(img.data_ptr(), hl, wl,
                                            pyr[0].data_ptr(), gsq[0].data_ptr(),
                                            nxt, stream)
        elif l == 0:
            err = lib.ldso_pyramid_level_f32(img.data_ptr(), 1, hl, wl,
                                             pyr[0].data_ptr(), gsq[0].data_ptr(),
                                             nxt, 1, stream)
        else:
            # channel 0 of this level's stack was written by the previous
            # launch; read it in place (stride 3) and leave it untouched
            err = lib.ldso_pyramid_level_f32(pyr[l].data_ptr(), 3, hl, wl,
                                             pyr[l].data_ptr(), gsq[l].data_ptr(),
                                             nxt, 0, stream)
        LAUNCHES += 1
        _check(err, l)
    return pyr, gsq
