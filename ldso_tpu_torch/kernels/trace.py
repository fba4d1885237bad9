"""CUDA kernels for the immature bank: the epipolar trace of every
candidate against a new frame (counterpart of the XLA program of the JAX
package's ``trace.trace_points`` inside ``frame_step._trace_core``) and
the activation GN of the candidates against the window (that of
``trace.optimize_idepth_bank`` under ``activate_candidates_device``); the
JAX package has no Pallas source for either.

The kernel source is ``ldso_tpu_torch/csrc/trace.cu``: ONE launch traces
the whole bank against a frame (``trace_bank_cuda``, a warp a row, a
sample a lane) and writes the bank's new fields as fresh tensors; ONE
launch runs the activation GN of every row (``activate_bank_cuda``, a CTA
a row, every target slot's 8 pattern points on lanes of their own). Each
kernel makes its slot tables (the slots' poses and affine transfers) from
the window's state, as ``frame_step.trace_slot_tables`` and
``trace.activation_slot_tables`` make them in torch (``trace_tables_cuda``
and ``activation_tables_cuda`` write out the kernels' own).
``frame_step._trace_core`` and ``trace.activate_candidates_device``
dispatch here for CUDA tensors. The plain versions are
``frame_step._trace_core_torch`` and ``trace.activate_candidates_torch``.
It is compiled with ``nvcc`` for ``sm_90a`` and ``-fmad=false`` (the
kernels follow torch's rounding operator by operator) at first use
(``kernels/cuda_build.py``) and bound with ``ctypes``. Nothing is compiled
or loaded at import.

``LAUNCHES_TRACE`` and ``LAUNCHES_ACTIVATE`` count kernel launches; each is
incremented, under a lock (the tracking and the mapping thread both
launch), only where its kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

import torch

from ldso_tpu_torch.kernels import cuda_build
from ldso_tpu_torch.trace import sweep_indices

SOURCE = cuda_build.csrc(__file__, "trace.cu")
NO_FMAD = ("-fmad=false",)      # no contraction into FMA
MAX_SAMPLES = 64                # two samples a lane
MAX_SLOTS = 32                  # kMaxSlots of the source
TRACE_DEBUG = 18                # a slot's debug row: T_hn [4, 4], alpha, beta
OUTLIER_ENERGY = 1800.0         # trace.trace_points' energy gate, at its default in _trace_core

LAUNCHES_TRACE = 0
LAUNCHES_ACTIVATE = 0
_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    global LAUNCHES_TRACE, LAUNCHES_ACTIVATE
    with _LAUNCHES_LOCK:
        LAUNCHES_TRACE = 0
        LAUNCHES_ACTIVATE = 0


def _count(name: str) -> None:
    global LAUNCHES_TRACE, LAUNCHES_ACTIVATE
    with _LAUNCHES_LOCK:
        if name == "trace":
            LAUNCHES_TRACE += 1
        else:
            LAUNCHES_ACTIVATE += 1


def build() -> str:
    """Compile csrc/trace.cu if need be; the library path."""
    return cuda_build.build(SOURCE, extra=NO_FMAD)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ldso_trace_bank: img3, H, W, valid, host_slot, uv, color, idepth_min,
# idepth_max, quality, last_status, outlier_count, N, T_eval, x, exposure, F,
# T_new_cw, ab_abs, exposure_new, intr, steps, K, sweep (packed), sweep_n,
# gn_iters, max_search, outlier_gate, min_quality, step_size, slack,
# gn_threshold, err_px, the 6 outputs, status, best_uv, best_idepth, debug,
# stream
TRACE_ARGTYPES = ([_P, _I, _I] + [_P] * 9 + [_I] + [_P] * 3 + [_I] + [_P, _P, _F]
                  + [_P, _P, _I, _I, _I, _I] + [_F] * 7 + [_P] * 10 + [_P])
# ldso_activate_bank: images, H, W, F, frame_valid, T_all, x, exposure,
# valid, host_slot, uv, color, idepth_min, idepth_max, quality, last_status,
# N, intr, iters, min_quality, huber, idepth, H_dd, energy, count, can,
# debug, stream
ACTIVATE_ARGTYPES = [_P, _I, _I, _I] + [_P] * 12 + [_I, _P, _I, _F, _F] + [_P] * 7


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE, extra=NO_FMAD)
    lib.ldso_trace_bank.argtypes, lib.ldso_trace_bank.restype = TRACE_ARGTYPES, _I
    lib.ldso_activate_bank.argtypes, lib.ldso_activate_bank.restype = ACTIVATE_ARGTYPES, _I
    return lib


def _check(kernel: str, name: str, t: torch.Tensor, dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{kernel} kernel: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel} kernel: {name} has shape {tuple(t.shape)}, not {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} is not contiguous")


def _same_device(kernel: str, tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{kernel} kernel: tensors on {dev} and {t.device}")
    return dev


def _needs_cuda(kernel: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {dev}")


_STEPS: dict = {}


def linspace_steps(k: int, dev: torch.device) -> torch.Tensor:
    """``torch.linspace(0, 1, k)`` on ``dev``, made once: the plain
    version's own sample fractions (linspace computes the upper half of the
    range from its end, so ``i / (k - 1)`` would differ in the last ulp)."""
    key = (k, str(dev))
    steps = _STEPS.get(key)
    if steps is None:
        steps = _STEPS.setdefault(key, torch.linspace(0.0, 1.0, k, device=dev))
    return steps


@functools.lru_cache(maxsize=None)
def sweep_word(sweep_pattern: int) -> tuple:
    """(packed, count): the pattern points ``trace.sweep_indices`` gives,
    3 bits each from the lowest, as the kernel reads them."""
    idx = sweep_indices(sweep_pattern)
    return sum(j << (3 * s) for s, j in enumerate(idx)), len(idx)


class TraceBankOut(NamedTuple):
    """The bank's fields after a trace, fresh tensors; with ``debug``
    also ``trace_points``' status, best_uv and best_idepth (NaN on invalid
    rows), else None."""

    valid: torch.Tensor            # [N] bool
    idepth_min: torch.Tensor       # [N] float32
    idepth_max: torch.Tensor
    quality: torch.Tensor
    last_status: torch.Tensor      # [N] int32
    outlier_count: torch.Tensor    # [N] int32
    status: Optional[torch.Tensor]
    best_uv: Optional[torch.Tensor]
    best_idepth: Optional[torch.Tensor]


def trace_bank_cuda(img3, bank, T_eval, x, exposure_all, T_new_cw, ab_abs, exposure_new: float,
                    intr, *, num_samples: int, gn_iters: int, max_pix_search_frac: float,
                    min_quality: float, step_size: float, slack_interval: float,
                    extra_slack: float, gn_threshold: float, sweep_pattern: int,
                    debug: bool = False, tables: Optional[torch.Tensor] = None) -> TraceBankOut:
    """ONE launch: trace every row of ``bank`` (``core.bank.Bank``, on the
    card) against ``img3`` [H, W, 3] float32 and apply the bank update of
    ``frame_step._trace_core``, whose arguments these are: the window's
    T_eval [F, 4, 4], x [F, 8] and exposure_all [F], the new frame's
    T_new_cw [4, 4], ab_abs [2] and exposure_new (a number); intr [4]. The
    kernel makes each slot's hostToNew pose and affine transfer itself
    (``frame_step.trace_slot_tables``' expressions). All float32 (valid
    bool, host_slot, last_status, outlier_count int32), contiguous, on one
    CUDA device. The options are ``trace.trace_points``' (its
    outlier_energy at its default); with ``debug`` the raw status, best_uv
    and best_idepth too; ``tables`` [F, TRACE_DEBUG] float32, when given,
    receives the slot tables (``trace_tables_cuda``)."""
    kn = "trace"
    dev = _same_device(kn, [img3, T_eval, x, exposure_all, T_new_cw, ab_abs, intr, *bank])
    if img3.ndim != 3 or img3.shape[2] != 3:
        raise ValueError(f"trace kernel: img3 has shape {tuple(img3.shape)}, not [H, W, 3]")
    h, w = img3.shape[0], img3.shape[1]
    n, F = bank.uv.shape[0], T_eval.shape[0]
    if not 1 <= num_samples <= MAX_SAMPLES:
        raise ValueError(f"trace kernel: {num_samples} samples, 1..{MAX_SAMPLES}")
    if not 1 <= F <= MAX_SLOTS or gn_iters < 0:
        raise ValueError(f"trace kernel: {F} slots (1..{MAX_SLOTS}), gn_iters {gn_iters}")
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
            ("img3", img3, f32, (h, w, 3)), ("T_eval", T_eval, f32, (F, 4, 4)),
            ("x", x, f32, (F, 8)), ("exposure_all", exposure_all, f32, (F,)),
            ("T_new_cw", T_new_cw, f32, (4, 4)), ("ab_abs", ab_abs, f32, (2,)),
            ("intr", intr, f32, (4,)),
            ("valid", bank.valid, torch.bool, (n,)), ("host_slot", bank.host_slot, i32, (n,)),
            ("uv", bank.uv, f32, (n, 2)), ("color", bank.color, f32, (n, 8)),
            ("idepth_min", bank.idepth_min, f32, (n,)),
            ("idepth_max", bank.idepth_max, f32, (n,)), ("quality", bank.quality, f32, (n,)),
            ("last_status", bank.last_status, i32, (n,)),
            ("outlier_count", bank.outlier_count, i32, (n,))):
        _check(kn, name, t, dt, shape)
    if tables is not None:
        _check(kn, "tables", tables, f32, (F, TRACE_DEBUG))
    _needs_cuda(kn, dev)
    steps = linspace_steps(num_samples, dev)
    # one buffer for the five 4-byte fields
    words = torch.empty((5, n), dtype=i32, device=dev)
    valid_o = torch.empty(n, dtype=torch.bool, device=dev)
    dmin_o, dmax_o, q_o = (words[r].view(f32) for r in range(3))
    st_o, oc_o = words[3], words[4]
    status = best_uv = best_id = None
    if debug:
        status = torch.empty(n, dtype=i32, device=dev)
        best_uv = torch.empty((n, 2), dtype=f32, device=dev)
        best_id = torch.empty(n, dtype=f32, device=dev)
    sweep, n_sweep = sweep_word(int(sweep_pattern))
    gate = (OUTLIER_ENERGY * n_sweep / 8.0) * (1.0 + extra_slack)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ldso_trace_bank(
            img3.data_ptr(), h, w, bank.valid.data_ptr(), bank.host_slot.data_ptr(),
            bank.uv.data_ptr(), bank.color.data_ptr(), bank.idepth_min.data_ptr(),
            bank.idepth_max.data_ptr(), bank.quality.data_ptr(), bank.last_status.data_ptr(),
            bank.outlier_count.data_ptr(), n, T_eval.data_ptr(), x.data_ptr(),
            exposure_all.data_ptr(), F, T_new_cw.data_ptr(), ab_abs.data_ptr(),
            float(exposure_new), intr.data_ptr(), steps.data_ptr(), num_samples, sweep, n_sweep,
            int(gn_iters), max_pix_search_frac * (w + h), gate, min_quality, step_size,
            slack_interval, gn_threshold, 1.0 + 0.5 * step_size, valid_o.data_ptr(),
            dmin_o.data_ptr(), dmax_o.data_ptr(), q_o.data_ptr(), st_o.data_ptr(),
            oc_o.data_ptr(), status.data_ptr() if debug else None,
            best_uv.data_ptr() if debug else None, best_id.data_ptr() if debug else None,
            None if tables is None else tables.data_ptr(), stream)
    _count("trace")
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: cudaError {err}")
    return TraceBankOut(valid_o, dmin_o, dmax_o, q_o, st_o, oc_o, status, best_uv, best_id)


def trace_tables_cuda(img3, bank, T_eval, x, exposure_all, T_new_cw, ab_abs, exposure_new: float,
                      intr, **kw) -> tuple:
    """The slot tables the trace kernel makes (one launch's debug output,
    CTA 0's), in ``frame_step.trace_slot_tables``' layout: T_hn [F, 4, 4]
    and (alpha, beta) [F, 2]. Arguments as ``trace_bank_cuda``'s; the bank
    needs a row."""
    F = T_eval.shape[0]
    if bank.uv.shape[0] < 1:
        raise ValueError("trace kernel: the tables need a bank of at least one row")
    out = torch.empty((F, TRACE_DEBUG), dtype=torch.float32, device=T_eval.device)
    trace_bank_cuda(img3, bank, T_eval, x, exposure_all, T_new_cw, ab_abs, exposure_new, intr,
                    tables=out, **kw)
    return out[:, :16].view(F, 4, 4), out[:, 16:]


def activate_bank_cuda(win_images, frame_valid, T_all, x, exposure_all, bank, intr,
                       min_quality: float, iters: int = 3, huber_th: float = 9.0,
                       tables: Optional[torch.Tensor] = None) -> dict:
    """ONE launch: the activation GN of every row of ``bank`` against the
    window's level-0 stacks ``win_images`` [F, H, W, 3] float32, with
    ``frame_valid`` [F] bool, the slots' poses T_all [F, 4, 4] (worldToCam),
    the window's state x [F, 8] and exposure_all [F], and intr [4]; the
    kernel makes the relative poses and affine transfers itself
    (``trace.activation_slot_tables``' expressions). Contiguous, on one CUDA
    device. Returns ``trace.activate_candidates_torch``'s dict: idepth,
    H_dd, energy, count [N] float32 and can [N] bool, fresh tensors.
    ``tables`` [18 F F] float32, when given, receives the tables
    (``activation_tables_cuda``)."""
    kn = "activate"
    dev = _same_device(kn, [win_images, frame_valid, T_all, x, exposure_all, intr, *bank])
    if win_images.ndim != 4 or win_images.shape[3] != 3:
        raise ValueError(f"activate kernel: win_images has shape {tuple(win_images.shape)}, "
                         f"not [F, H, W, 3]")
    F, h, w = win_images.shape[0], win_images.shape[1], win_images.shape[2]
    n = bank.uv.shape[0]
    if not 1 <= F <= MAX_SLOTS or iters < 0:
        raise ValueError(f"activate kernel: {F} slots (1..{MAX_SLOTS}), iters {iters}")
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
            ("win_images", win_images, f32, (F, h, w, 3)), ("T_all", T_all, f32, (F, 4, 4)),
            ("x", x, f32, (F, 8)), ("exposure_all", exposure_all, f32, (F,)),
            ("frame_valid", frame_valid, torch.bool, (F,)), ("intr", intr, f32, (4,)),
            ("valid", bank.valid, torch.bool, (n,)), ("host_slot", bank.host_slot, i32, (n,)),
            ("uv", bank.uv, f32, (n, 2)), ("color", bank.color, f32, (n, 8)),
            ("idepth_min", bank.idepth_min, f32, (n,)),
            ("idepth_max", bank.idepth_max, f32, (n,)), ("quality", bank.quality, f32, (n,)),
            ("last_status", bank.last_status, i32, (n,))):
        _check(kn, name, t, dt, shape)
    if tables is not None:
        _check(kn, "tables", tables, f32, (18 * F * F,))
    _needs_cuda(kn, dev)
    sums = torch.empty((4, n), dtype=f32, device=dev)
    can = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ldso_activate_bank(
            win_images.data_ptr(), h, w, F, frame_valid.data_ptr(), T_all.data_ptr(),
            x.data_ptr(), exposure_all.data_ptr(), bank.valid.data_ptr(),
            bank.host_slot.data_ptr(), bank.uv.data_ptr(), bank.color.data_ptr(),
            bank.idepth_min.data_ptr(), bank.idepth_max.data_ptr(), bank.quality.data_ptr(),
            bank.last_status.data_ptr(), n, intr.data_ptr(), int(iters), float(min_quality),
            float(huber_th), sums[0].data_ptr(), sums[1].data_ptr(), sums[2].data_ptr(),
            sums[3].data_ptr(), can.data_ptr(), None if tables is None else tables.data_ptr(),
            stream)
    _count("activate")
    if err != 0:
        raise RuntimeError(f"activate kernel launch failed: cudaError {err}")
    return dict(idepth=sums[0], H_dd=sums[1], energy=sums[2], count=sums[3], can=can)


def activation_tables_cuda(win_images, frame_valid, T_all, x, exposure_all, bank, intr,
                           min_quality: float, **kw) -> tuple:
    """The tables the activation kernel makes (one launch's debug output,
    CTA 0's), in ``trace.activation_slot_tables``' layout: T_rel
    [F, F, 4, 4] ([f, h] = T_all[f] T_all[h]^-1) and alpha, beta [F, F]
    (host h to target f). Arguments as ``activate_bank_cuda``'s; the bank
    needs a row."""
    F = T_all.shape[0]
    if bank.uv.shape[0] < 1:
        raise ValueError("activate kernel: the tables need a bank of at least one row")
    out = torch.empty(18 * F * F, dtype=torch.float32, device=T_all.device)
    activate_bank_cuda(win_images, frame_valid, T_all, x, exposure_all, bank, intr, min_quality,
                       tables=out, **kw)
    return (out[:16 * F * F].view(F, F, 4, 4), out[16 * F * F:17 * F * F].view(F, F),
            out[17 * F * F:].view(F, F))
