"""CUDA kernel for the monocular bootstrap's Gauss-Newton loop at one
pyramid level (K6): counterpart of the XLA program of the JAX package's
``init2f.init_level``, a ``lax.scan`` over the level's iterations; it has
no Pallas source.

The kernel source is ``ldso_tpu_torch/csrc/init_level.cu``: ONE launch runs
all ``iters`` iterations of one level on one thread-block cluster of
``CLUSTER`` CTAs, each holding its points' state and system
double-buffered in shared memory and taking every step itself, so the host
reads nothing back inside a level (see the note at the top of the source).
``init2f.init_level`` dispatches here for CUDA tensors; the plain version is
``init2f.init_level_torch``. The source is compiled with ``nvcc`` for
``sm_90a`` at first use (``kernels/cuda_build.py``) and bound with
``ctypes``; ``phases=True`` takes a second library built with
``-DINIT_LEVEL_PHASES``, whose launches also write clock64() cycles per
phase. Nothing is compiled or loaded at import.

``LAUNCHES`` counts kernel launches (one a level); it is incremented, under
a lock, only where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from ldso_tpu_torch.kernels import cuda_build

SOURCE = cuda_build.csrc(__file__, "init_level.cu")
PHASES = ("INIT_LEVEL_PHASES",)      # the instrumented library's define
# what an instrumented launch writes (thread 0 of the rank-0 CTA): the
# cycles before the first iteration, then of each phase summed over the
# iterations, the launch's whole cycles and its iterations
PHASE_NAMES = ("start", "schur", "warp_reduce", "cross_warp", "cross_cta", "step_rows",
               "step_lu", "step_solve", "step_exp", "barrier", "trial_median", "trial_gather",
               "trial_accum", "accept", "level", "iterations")
MAX_NEIGHBORS = 16     # kMaxK
THREADS = 512          # kThreads: a launch's threads, its CTAs together
CLUSTER = 8            # kCluster: the CTAs of every launch, one cluster
MAX_POINTS = 10752     # kMaxN: the most points the cluster's shared memory holds

LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()      # a bootstrap may run on a tracking thread


def reset_launches() -> None:
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES = 0


def build(phases: bool = False) -> str:
    """Compile csrc/init_level.cu if need be; the library path."""
    return cuda_build.build(SOURCE, PHASES if phases else ())


def launch_config(n: int) -> tuple:
    """The launch shape over ``n`` points (1 <= n <= MAX_POINTS): (CTAs of
    the cluster, threads a CTA), fixed by the source whatever ``n``."""
    return CLUSTER, THREADS // CLUSTER


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ldso_init_level's: img3, H, W, uv, colors, nbr, N, K, T0, ab0, d0, iR0,
# good0, intr0, level, iters, snapped, alpha_w, coupling, reg_keep,
# reg_weight, huber, T_out, ab_out, d_out, iR_out, good_out, scalars_out,
# counts_out, ladder_out, phases_out, stream
ARGTYPES = [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
            _F, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]


def bind(src: str, phases: bool = False) -> ctypes.CDLL:
    """The library of the source at ``src`` (this package's, or another
    checkout's of the same C entry), built if need be, its entry typed."""
    lib = cuda_build.load(src, PHASES if phases else ())
    lib.ldso_init_level.argtypes = ARGTYPES
    lib.ldso_init_level.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=2)
def _lib(phases: bool = False) -> ctypes.CDLL:
    return bind(SOURCE, phases)


class LevelOut(NamedTuple):
    """A launch's outputs: ``init2f.InitLevelOut``'s eight fields, then the
    samples with om > 0 summed over the level's 1 + iters evaluations
    (int64, what the work of the run was) and, if asked for, the ladder
    and the instrumented build's cycles (``PHASE_NAMES``)."""

    T: torch.Tensor           # [4, 4] float32
    ab: torch.Tensor          # [2]
    idepth: torch.Tensor      # [N]
    iR: torch.Tensor          # [N]
    good: torch.Tensor        # [N] bool: good & pt_ok of the carried system
    energy: torch.Tensor      # [] float32
    t_norm_sq: torch.Tensor   # [] float32
    n_good: torch.Tensor      # [] int64
    n_ok_sum: torch.Tensor    # [] int64
    ladder: Optional[torch.Tensor]   # [iters, 2] float32: E and the trial's E' an iteration
    phases: Optional[torch.Tensor] = None   # [len(PHASE_NAMES)] int64


def _check(name: str, t: torch.Tensor, dtype, shape: tuple, dev: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"init_level kernel: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"init_level kernel: {name} has shape {tuple(t.shape)}, not {shape}")
    if not t.is_contiguous():
        raise ValueError(f"init_level kernel: {name} is not contiguous")
    if t.device != dev:
        raise ValueError(f"init_level kernel: {name} is on {t.device}, not {dev}")


def check_args(img3, uv, colors, neighbors, T0, ab0, idepth0, iR0, good0, intr0,
               level: int, iters: int) -> tuple:
    """Refuse what the kernel does not take, before anything is built: more
    than MAX_POINTS points or MAX_NEIGHBORS neighbours; a tensor of another
    dtype or shape, not contiguous, or off the device of ``uv``; a device
    that is not CUDA. Returns (N, K)."""
    n, k = uv.shape[0], neighbors.shape[-1]
    if not 1 <= n <= MAX_POINTS:
        raise ValueError(f"init_level kernel: {n} points, 1..{MAX_POINTS}")
    if not 1 <= k <= MAX_NEIGHBORS:
        raise ValueError(f"init_level kernel: {k} neighbours, 1..{MAX_NEIGHBORS}")
    if img3.dim() != 3 or img3.shape[2] != 3 or img3.shape[0] < 1 or img3.shape[1] < 1:
        raise ValueError(f"init_level kernel: img3 has shape {tuple(img3.shape)}")
    if level < 0 or iters < 0:
        raise ValueError(f"init_level kernel: level {level}, iters {iters}")
    f32, dev = torch.float32, uv.device
    for name, t, dtype, shape in (
            ("img3", img3, f32, tuple(img3.shape)), ("uv", uv, f32, (n, 2)),
            ("colors", colors, f32, (n, 8)), ("neighbors", neighbors, torch.int32, (n, k)),
            ("T0", T0, f32, (4, 4)), ("ab0", ab0, f32, (2,)), ("idepth0", idepth0, f32, (n,)),
            ("iR0", iR0, f32, (n,)), ("good0", good0, torch.bool, (n,)),
            ("intr0", intr0, f32, (4,))):
        _check(name, t, dtype, shape, dev)
    if dev.type != "cuda":
        raise ValueError(f"init_level kernel needs CUDA tensors, got {dev}")
    return n, k


def init_level_cuda(img3, uv, colors, neighbors, T0, ab0, idepth0, iR0, good0, intr0,
                    level: int, iters: int, snapped: bool, alpha_w: float = 150.0 * 150.0,
                    alpha_k: float = 2.5e5, coupling: float = 1.0, reg_weight: float = 0.8,
                    huber_th: float = 9.0, ladder: bool = False, phases: bool = False,
                    lib: Optional[ctypes.CDLL] = None) -> LevelOut:
    """``init2f.init_level`` at one level in ONE launch, on the card, on the
    current stream: the arguments and results of ``init2f.init_level_torch``
    (``alpha_k`` is unused there too), every tensor contiguous on one CUDA
    device (neighbors int32 [N, K], good0 bool). With ``ladder``, also E and
    the trial's E' of each iteration; with ``phases``, the launch runs the
    library built with ``-DINIT_LEVEL_PHASES`` and returns its cycles.
    ``lib`` (from ``bind``) launches another build of the same entry."""
    n, _ = check_args(img3, uv, colors, neighbors, T0, ab0, idepth0, iR0, good0, intr0,
                      level, iters)
    dev = uv.device
    f = torch.empty(20 + 2 * n, dtype=torch.float32, device=dev)
    counts = torch.empty(2, dtype=torch.int64, device=dev)
    good = torch.empty(n, dtype=torch.bool, device=dev)
    lad = torch.empty((iters, 2), dtype=torch.float32, device=dev) if ladder else None
    ph = torch.zeros(len(PHASE_NAMES), dtype=torch.int64, device=dev) if phases else None
    T, ab, scalars = f[:16].view(4, 4), f[16:18], f[18:20]
    idepth, iR = f[20:20 + n], f[20 + n:]
    lib = lib if lib is not None else _lib(phases)
    global LAUNCHES
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        # the foreign call releases the interpreter lock; the count is
        # updated outside it
        err = lib.ldso_init_level(
            img3.data_ptr(), img3.shape[0], img3.shape[1], uv.data_ptr(), colors.data_ptr(),
            neighbors.data_ptr(), n, neighbors.shape[1], T0.data_ptr(), ab0.data_ptr(),
            idepth0.data_ptr(), iR0.data_ptr(), good0.data_ptr(), intr0.data_ptr(), int(level),
            int(iters), int(bool(snapped)), float(alpha_w), float(coupling),
            float(1.0 - reg_weight), float(reg_weight), float(huber_th), T.data_ptr(),
            ab.data_ptr(), idepth.data_ptr(), iR.data_ptr(), good.data_ptr(),
            scalars.data_ptr(), counts.data_ptr(), None if lad is None else lad.data_ptr(),
            None if ph is None else ph.data_ptr(), stream)
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"init_level kernel launch failed: cudaError {err}")
    return LevelOut(T, ab, idepth, iR, good, scalars[0], scalars[1], counts[0], counts[1], lad,
                    ph)
