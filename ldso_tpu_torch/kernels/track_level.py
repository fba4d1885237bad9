"""CUDA kernel for one pyramid level of the coarse tracker's LM loop
(counterpart of the XLA program of the JAX package's
``tracker.track_level``, a ``lax.while_loop`` vmapped over the motion
hypotheses; it has no Pallas source).

The kernel source is ``ldso_tpu_torch/csrc/track_level.cu``: ONE launch
runs the whole Levenberg-Marquardt loop of K lanes, a thread block per
lane; each lane stops on its own done flag or at the iteration cap, so the
host reads nothing back (see the note at the top of the source). It is
compiled with ``nvcc`` for ``sm_90a`` at first use
(``kernels/cuda_build.py``) and bound with ``ctypes``. Nothing is compiled
or loaded at import. The plain version is ``tracker.track_level_torch``.

``LAUNCHES`` counts kernel launches (one per call); it is incremented only
where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ldso_tpu_torch.kernels import cuda_build

SOURCE = cuda_build.csrc(__file__, "track_level.cu")
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()      # tracking and mapping threads both count


def reset_launches() -> None:
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES = 0


def build() -> str:
    """Compile csrc/track_level.cu if need be; the library path."""
    return cuda_build.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # img3, H, W, uv, idepth, color, valid, N, T0, ab0, intr, K, iters,
    # cutoff, huber, lam0, lam_success, lam_fail, step_eps,
    # T, ab, rmse, n_ok, n_in, n_sat, n_iter, n_ok_sum, stream
    lib.ldso_track_level.argtypes = [p, i, i, p, p, p, p, i, p, p, p, i, i,
                                     f, f, f, f, f, f, p, p, p, p, p, p, p, p, p]
    lib.ldso_track_level.restype = i
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape: tuple, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"track_level kernel: {name} is on {t.device}, not {dev}")
    if t.dtype != dtype:
        raise TypeError(f"track_level kernel: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"track_level kernel: {name} has shape {tuple(t.shape)}, "
                         f"not {shape}")
    if not t.is_contiguous():
        raise ValueError(f"track_level kernel: {name} is not contiguous")


def track_level_cuda(img3, uv, idepth, color, valid, T0, ab0, intr_l,
                     w: int, h: int, iters: int, cutoff: float, huber_th: float,
                     lam0: float = 0.01, lam_success: float = 0.5,
                     lam_fail: float = 4.0, step_eps: float = 1e-6):
    """LM at one pyramid level for K lanes, in one launch, on the card.

    img3 [h, w, 3] float32 (I, dx, dy); uv [N, 2], idepth [N], color [N]
    float32, valid [N] bool; T0 [K, 4, 4], ab0 [K, 2], intr_l [4] float32;
    all contiguous on one CUDA device. Returns (T, ab, rmse, n_ok, n_in,
    n_sat, n_iter, n_ok_sum): those of ``tracker.track_level_torch``
    (counts int64), the iterations each lane ran (int32) and its n_ok
    summed over its 1 + n_iter evaluations (int64, the points that took
    the Jacobian and the sums)."""
    dev = T0.device
    if dev.type != "cuda":
        raise ValueError(f"track_level_cuda needs CUDA tensors, got {dev}")
    K, N = T0.shape[0], uv.shape[0]
    f32 = torch.float32
    for name, t, dtype, shape in (
            ("img3", img3, f32, (h, w, 3)), ("uv", uv, f32, (N, 2)),
            ("idepth", idepth, f32, (N,)), ("color", color, f32, (N,)),
            ("valid", valid, torch.bool, (N,)), ("T0", T0, f32, (K, 4, 4)),
            ("ab0", ab0, f32, (K, 2)), ("intr_l", intr_l, f32, (4,))):
        _check(name, t, dtype, shape, dev)
    if iters < 0 or h < 1 or w < 1:
        raise ValueError(f"track_level kernel: iters {iters}, image {w}x{h}")
    global LAUNCHES
    lib = _lib()
    T = torch.empty((K, 4, 4), dtype=f32, device=dev)
    ab = torch.empty((K, 2), dtype=f32, device=dev)
    rmse = torch.empty((K,), dtype=f32, device=dev)
    n_ok, n_in, n_sat = (torch.empty((K,), dtype=torch.int64, device=dev)
                         for _ in range(3))
    n_iter = torch.empty((K,), dtype=torch.int32, device=dev)
    n_ok_sum = torch.empty((K,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        # the foreign call releases the interpreter lock; the count is
        # updated outside it
        err = lib.ldso_track_level(
            img3.data_ptr(), h, w, uv.data_ptr(), idepth.data_ptr(), color.data_ptr(),
            valid.data_ptr(), N, T0.data_ptr(), ab0.data_ptr(), intr_l.data_ptr(), K,
            int(iters), float(cutoff), float(huber_th), float(lam0), float(lam_success),
            float(lam_fail), float(step_eps), T.data_ptr(), ab.data_ptr(), rmse.data_ptr(),
            n_ok.data_ptr(), n_in.data_ptr(), n_sat.data_ptr(), n_iter.data_ptr(),
            n_ok_sum.data_ptr(), stream)
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"track_level kernel launch failed: cudaError {err}")
    return T, ab, rmse, n_ok, n_in, n_sat, n_iter, n_ok_sum
