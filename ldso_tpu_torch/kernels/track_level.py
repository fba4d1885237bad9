"""CUDA kernel for the coarse tracker's LM loop over a chain of pyramid
levels (counterpart of the XLA program of the JAX package's
``tracker.track_level``, a ``lax.while_loop`` vmapped over the motion
hypotheses, and of the level chain of its ``track_frame``; it has no
Pallas source).

The kernel source is ``ldso_tpu_torch/csrc/track_level.cu``: ONE launch
runs the whole Levenberg-Marquardt loop of K lanes over a table of levels,
a thread-block cluster per lane, each lane chaining from one level to the
next and stopping at each on its own done flag or the level's cap, so the
host reads nothing back (see the note at the top of the source). A tracked
frame is two launches (``track_levels_cuda``): the coarse levels for every
lane, then the winner's pick and the fine levels. ``track_level_cuda`` is
the same kernel on a one-level table. ``launch_config`` alone sets a
launch's cluster size and block size, from its lane count, so a one-level
call at a level runs what the chained launch runs there, bit for bit. It is compiled with
``nvcc`` for ``sm_90a`` at first use (``kernels/cuda_build.py``) and bound
with ``ctypes``; ``phases=True`` takes a second library built with
``-DTRACK_LEVEL_PHASES``, whose launches also write clock64() cycles per
phase. Nothing is compiled or loaded at import. The plain version is
``tracker.track_level_torch``.

``LAUNCHES`` counts kernel launches (one per launch of either library); it
is incremented only where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from ldso_tpu_torch.kernels import cuda_build

SOURCE = cuda_build.csrc(__file__, "track_level.cu")
PHASES = ("TRACK_LEVEL_PHASES",)      # the instrumented library's define
# what an instrumented launch writes per level and lane (thread 0 of the
# lane's rank-0 CTA): cycles of six phases, of the whole level, the count
# of evaluations, then cycles of the step's four parts
PHASE_NAMES = ("points", "warp_reduce", "cross_warp", "cross_cta", "step", "barrier",
               "level", "evaluations", "step_rows", "step_lu", "step_solve", "step_exp")
MAX_LEVELS = 8
# (cluster size, threads a CTA) of a launch of many lanes (the coarse
# levels) and of one lane (the fine levels): on bench frames of the H100
# one CTA a lane is the fastest at the coarse levels (27 lanes of 256 / 512
# points: the exchange between CTAs costs more than the points it spreads),
# a cluster of 8, the portable size, at the fine ones (PERF.md, K2)
COARSE_LAUNCH, FINE_LAUNCH = (1, 256), (8, 256)

LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()      # tracking and mapping threads both count


def reset_launches() -> None:
    global LAUNCHES
    with _LAUNCHES_LOCK:
        LAUNCHES = 0


def build(phases: bool = False) -> str:
    """Compile csrc/track_level.cu if need be; the library path."""
    return cuda_build.build(SOURCE, PHASES if phases else ())


def launch_config(lanes: int) -> tuple:
    """(cluster size, threads a CTA) of a launch of ``lanes`` lanes."""
    return COARSE_LAUNCH if lanes > 1 else FINE_LAUNCH


@functools.lru_cache(maxsize=2)
def _lib(phases: bool) -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE, PHASES if phases else ())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # level_ptrs, level_ints, cutoffs, n_levels, intr, T0, T0_stride, ab0,
    # ab0_stride, pick_rmse, k_in, lanes, lanes_cap, cluster, threads,
    # huber, lam0, lam_success, lam_fail, step_eps, T, ab, rmse, n_ok,
    # n_in, n_sat, n_iter, n_ok_sum, best, phases, stream
    lib.ldso_track_levels.argtypes = [p, p, p, i, p, p, i, p, i, p, i, i, i, i, i,
                                      f, f, f, f, f, p, p, p, p, p, p, p, p, p, p, p]
    lib.ldso_track_levels.restype = i
    return lib


class Level(NamedTuple):
    """One entry of a launch's level table."""

    img3: torch.Tensor        # [h, w, 3] float32 (I, dx, dy)
    uv: torch.Tensor          # [N, 2] float32
    idepth: torch.Tensor      # [N] float32
    color: torch.Tensor       # [N] float32
    valid: torch.Tensor       # [N] bool
    iters: int                # the level's iteration cap
    cutoff: float
    intr_row: int             # row of the intrinsics table
    slot: int                 # row of the outputs


class LevelsOut(NamedTuple):
    """A launch's outputs, [slots, lanes, ...], views of one buffer."""

    T: torch.Tensor           # [S, K, 4, 4] float32
    ab: torch.Tensor          # [S, K, 2] float32
    rmse: torch.Tensor        # [S, K] float32
    n_ok: torch.Tensor        # [S, K] int64
    n_in: torch.Tensor
    n_sat: torch.Tensor
    n_iter: torch.Tensor      # [S, K] int32, iterations run
    n_ok_sum: torch.Tensor    # [S, K] int64, n_ok over the lane's evaluations
    best: torch.Tensor        # [1] int32, the winner the fine launch picked
    phases: Optional[torch.Tensor]   # [S, K, len(PHASE_NAMES)] int64 (instrumented)


def alloc_out(slots: int, lanes: int, dev: torch.device, phases: bool = False) -> LevelsOut:
    """One device buffer for a frame's (or a level's) outputs, cut into
    8-byte aligned views."""
    parts = [(torch.float32, (slots, lanes, 4, 4)), (torch.float32, (slots, lanes, 2)),
             (torch.float32, (slots, lanes)), (torch.int64, (slots, lanes)),
             (torch.int64, (slots, lanes)), (torch.int64, (slots, lanes)),
             (torch.int32, (slots, lanes)), (torch.int64, (slots, lanes)),
             (torch.int32, (1,))]
    if phases:
        parts.append((torch.int64, (slots, lanes, len(PHASE_NAMES))))
    sizes = []
    for dt, shape in parts:
        nbytes = dt.itemsize * torch.Size(shape).numel()
        sizes.append((nbytes + 7) // 8 * 8)
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
    views, off = [], 0
    for (dt, shape), nb in zip(parts, sizes):
        count = torch.Size(shape).numel()
        views.append(buf[off:off + count * dt.itemsize].view(dt).view(shape))
        off += nb
    if not phases:
        views.append(None)
    return LevelsOut(*views)


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


def launch(levels: Sequence[Level], intr: torch.Tensor, T0: torch.Tensor, ab0: torch.Tensor,
           out: LevelsOut, lanes: int, *, huber_th: float, lam0: float, lam_success: float,
           lam_fail: float, step_eps: float, pick_rmse: Optional[torch.Tensor] = None) -> None:
    """ONE launch of the kernel over ``levels``, in order, for ``lanes``
    lanes, on the current stream: lane k starts at T0[k], ab0[k] (ab0 of
    shape [2]: every lane at ab0), or, with ``pick_rmse`` [k_in], every
    lane at the entry of T0 / ab0 that the argmin of pick_rmse picks (NaN
    and +-inf as +inf, the lowest index at a tie; written to
    ``out.best``). Writes ``out``'s [level.slot, lane] entries."""
    dev = intr.device
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"track_level kernel: {len(levels)} levels, 1..{MAX_LEVELS}")
    f32 = torch.float32
    k_in = T0.shape[0]
    _check("intr", intr, f32, (intr.shape[0], 4), dev)
    _check("T0", T0, f32, (k_in, 4, 4), dev)
    if tuple(ab0.shape) == (2,):
        ab_stride = 0
        _check("ab0", ab0, f32, (2,), dev)
    else:
        ab_stride = 2
        _check("ab0", ab0, f32, (k_in, 2), dev)
    if pick_rmse is not None:
        _check("pick_rmse", pick_rmse, f32, (k_in,), dev)
    elif lanes > k_in:
        raise ValueError(f"track_level kernel: {lanes} lanes from {k_in} start states")
    slots, cap = out.rmse.shape
    if not 1 <= lanes <= cap:
        raise ValueError(f"track_level kernel: {lanes} lanes, the outputs hold {cap}")
    ptrs, ints, cuts = [], [], []
    for i, lv in enumerate(levels):
        h, w = lv.img3.shape[0], lv.img3.shape[1]
        n = lv.uv.shape[0]
        for name, t, dtype, shape in (
                ("img3", lv.img3, f32, (h, w, 3)), ("uv", lv.uv, f32, (n, 2)),
                ("idepth", lv.idepth, f32, (n,)), ("color", lv.color, f32, (n,)),
                ("valid", lv.valid, torch.bool, (n,))):
            _check(f"level {i} {name}", t, dtype, shape, dev)
        if lv.iters < 0 or h < 1 or w < 1:
            raise ValueError(f"track_level kernel: iters {lv.iters}, image {w}x{h}")
        if not (0 <= lv.intr_row < intr.shape[0] and 0 <= lv.slot < slots):
            raise ValueError(f"track_level kernel: intrinsics row {lv.intr_row}, slot "
                             f"{lv.slot}")
        ptrs += [lv.img3.data_ptr(), lv.uv.data_ptr(), lv.idepth.data_ptr(),
                 lv.color.data_ptr(), lv.valid.data_ptr()]
        ints += [h, w, n, int(lv.iters), int(lv.intr_row), int(lv.slot)]
        cuts.append(float(lv.cutoff))
    c, threads = launch_config(lanes)
    if dev.type != "cuda":
        raise ValueError(f"track_level kernel needs CUDA tensors, got {dev}")
    phases = out.phases is not None
    lib = _lib(phases)
    global LAUNCHES
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        # the foreign call releases the interpreter lock; the count is
        # updated outside it
        err = lib.ldso_track_levels(
            (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(cuts))(*cuts), len(levels), intr.data_ptr(),
            T0.data_ptr(), 16, ab0.data_ptr(), ab_stride,
            None if pick_rmse is None else pick_rmse.data_ptr(), k_in, lanes, cap, c,
            threads, float(huber_th), float(lam0), float(lam_success), float(lam_fail),
            float(step_eps), out.T.data_ptr(), out.ab.data_ptr(), out.rmse.data_ptr(),
            out.n_ok.data_ptr(), out.n_in.data_ptr(), out.n_sat.data_ptr(),
            out.n_iter.data_ptr(), out.n_ok_sum.data_ptr(), out.best.data_ptr(),
            out.phases.data_ptr() if phases else None, stream)
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"track_level kernel launch failed: cudaError {err}")


def track_level_cuda(img3, uv, idepth, color, valid, T0, ab0, intr_l,
                     w: int, h: int, iters: int, cutoff: float, huber_th: float,
                     lam0: float = 0.01, lam_success: float = 0.5,
                     lam_fail: float = 4.0, step_eps: float = 1e-6, phases: bool = False):
    """LM at one pyramid level for K lanes, in one launch (a one-level
    table), on the card.

    img3 [h, w, 3] float32 (I, dx, dy); uv [N, 2], idepth [N], color [N]
    float32, valid [N] bool; T0 [K, 4, 4], ab0 [K, 2], intr_l [4] float32;
    all contiguous on one CUDA device. Returns (T, ab, rmse, n_ok, n_in,
    n_sat, n_iter, n_ok_sum): those of ``tracker.track_level_torch``
    (counts int64), the iterations each lane ran (int32) and its n_ok
    summed over its 1 + n_iter evaluations (int64, the points that took
    the Jacobian and the sums); with ``phases``, also the [K, 12] counts of
    ``PHASE_NAMES``."""
    dev = T0.device
    if dev.type != "cuda":
        raise ValueError(f"track_level_cuda needs CUDA tensors, got {dev}")
    K = T0.shape[0]
    if tuple(ab0.shape) != (K, 2):
        raise ValueError(f"track_level kernel: ab0 has shape {tuple(ab0.shape)}, not {(K, 2)}")
    if tuple(img3.shape[:2]) != (h, w):
        raise ValueError(f"track_level kernel: img3 is {tuple(img3.shape)}, not {w}x{h}")
    _check("intr_l", intr_l, torch.float32, (4,), dev)
    out = alloc_out(1, K, dev, phases)
    launch([Level(img3, uv, idepth, color, valid, iters, cutoff, 0, 0)], intr_l.view(1, 4),
           T0, ab0, out, K, huber_th=huber_th, lam0=lam0, lam_success=lam_success,
           lam_fail=lam_fail, step_eps=step_eps)
    res = tuple(t[0] for t in out[:8])
    return res + (out.phases[0],) if phases else res


def track_levels_cuda(pyr, ref, plan, intr_levels, T_inits, ab_init, huber_th: float,
                      lam0: float, lam_success: float, lam_fail: float, step_eps: float,
                      phases: bool = False) -> LevelsOut:
    """A tracked frame's levels in two launches: ``plan`` = (coarse, fine),
    ``tracker.LevelPlan``s in chain order. The coarse launch runs every
    lane of T_inits [K, 4, 4] (at ab_init [2]) through the coarse levels;
    the fine launch picks the winner from the last coarse level's rmse on
    the card and runs it through the fine levels. Returns the outputs,
    [levels, K, ...] with slot = level (a fine level fills lane 0)."""
    coarse, fine = plan
    if not coarse or not fine:
        raise ValueError("track_level kernel: a tracked frame needs coarse and fine levels")
    dev, K = T_inits.device, T_inits.shape[0]
    out = alloc_out(len(pyr), K, dev, phases)

    def table(levels):
        return [Level(pyr[p.level], ref.uv[p.level], ref.idepth[p.level], ref.color[p.level],
                      ref.valid[p.level], p.cap, p.cutoff, p.intr_row, p.level)
                for p in levels]

    lm = dict(huber_th=huber_th, lam0=lam0, lam_success=lam_success, lam_fail=lam_fail,
              step_eps=step_eps)
    launch(table(coarse), intr_levels, T_inits, ab_init.reshape(2), out, K, **lm)
    last = coarse[-1].level
    launch(table(fine), intr_levels, out.T[last], out.ab[last], out, 1,
           pick_rmse=out.rmse[last], **lm)
    return out
