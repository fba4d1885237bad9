"""CUDA kernel for the motion prediction of the per-frame program (K7): the
constant-velocity pose T_cv = (T_last T_prelast^-1) T_last and the
tracker's ``num`` motion hypotheses around it (the chain of
``tracker.motion_hypotheses``), in ONE launch. The JAX package runs the
same chain inside its per-frame XLA program and has no Pallas source for it.

The kernel source is ``ldso_tpu_torch/csrc/predict.cu``; it follows
torch's rounding operator by operator (``csrc/lie.cuh``), so its
hypotheses are the plain chain's bit for bit on the card.
``tracker.predict_hypotheses`` dispatches here for CUDA tensors; the plain
version is that function on CPU tensors. It is compiled with ``nvcc`` for
``sm_90a`` and ``-fmad=false`` at first use (``kernels/cuda_build.py``) and
bound with ``ctypes``. Nothing is compiled or loaded at import.

``LAUNCHES`` counts kernel launches, under a lock as the other wrappers'
counters; each launch also adds one to the span recorder's
``predict.kernel`` counter.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ldso_tpu_torch import telemetry
from ldso_tpu_torch.kernels import cuda_build

SOURCE = cuda_build.csrc(__file__, "predict.cu")
NO_FMAD = ("-fmad=false",)      # no contraction into FMA

LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES = 0


def _count() -> None:
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    telemetry.count("predict.kernel")


def build() -> str:
    """Compile csrc/predict.cu if need be; the library path."""
    return cuda_build.build(SOURCE, extra=NO_FMAD)


_P, _I = ctypes.c_void_p, ctypes.c_int
# ldso_predict_hypotheses: T_last, T_prelast, num, out, stream
ARGTYPES = [_P, _P, _I, _P, _P]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE, extra=NO_FMAD)
    lib.ldso_predict_hypotheses.argtypes = ARGTYPES
    lib.ldso_predict_hypotheses.restype = _I
    return lib


def predict_hypotheses_cuda(T_last: torch.Tensor, T_prelast: torch.Tensor,
                            num: int) -> torch.Tensor:
    """ONE launch: the [num, 4, 4] float32 hypotheses of
    ``motion_hypotheses(se3_mul(se3_mul(T_last, se3_inverse(T_prelast)),
    T_last), num)``, a fresh tensor. T_last and T_prelast are [4, 4]
    float32 refToNew poses, contiguous, on one CUDA device. Launches on the
    current stream and does not synchronise."""
    if num < 1:
        raise ValueError(f"predict kernel: {num} hypotheses, at least 1")
    for name, t in (("T_last", T_last), ("T_prelast", T_prelast)):
        if t.dtype != torch.float32:
            raise TypeError(f"predict kernel: {name} is {t.dtype}, not torch.float32")
        if tuple(t.shape) != (4, 4):
            raise ValueError(f"predict kernel: {name} has shape {tuple(t.shape)}, not (4, 4)")
        if not t.is_contiguous():
            raise ValueError(f"predict kernel: {name} is not contiguous")
    dev = T_last.device
    if T_prelast.device != dev:
        raise ValueError(f"predict kernel: tensors on {dev} and {T_prelast.device}")
    if dev.type != "cuda":
        raise ValueError(f"predict kernel needs CUDA tensors, got {dev}")
    out = torch.empty((num, 4, 4), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.ldso_predict_hypotheses(T_last.data_ptr(), T_prelast.data_ptr(), int(num),
                                          out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _count()
    if err != 0:
        raise RuntimeError(f"predict kernel launch failed: cudaError {err}")
    return out
