"""CUDA kernels for the windowed BA's linearization (K4): counterpart of the
XLA program of the JAX package's ``ba/residuals.assemble`` and of its
``energy_only``; the JAX package has no Pallas source for either.

The kernel source is ``ldso_tpu_torch/csrc/ba.cu``. An evaluation is TWO
launches: ``ba_linearize`` (a warp a point, 4 target slots x 8 pattern
points on its lanes) writes every per-point output (``H_xd``, ``H_dd``,
``b_d``, ``e_pair``, the masks) and a compact per-point record of the
point's contributions to the reduced camera system; ``ba_reduce`` sums the
records into ``H``, ``b``, the energy and the residual count, each entry in
a fixed order of points, by the table ``reduce_table`` gives it, so that a
second launch on the same inputs gives the same bits. ``energy_only_cuda``
is the same pair of launches without the Jacobians. The per-slot-pair work
(``residuals.precompute_pairs``) is the caller's, in torch
(``residuals.ba_slot_tables``): ``residuals.assemble`` and
``residuals.energy_only`` dispatch here for CUDA tensors. The plain
versions are ``residuals.assemble_torch`` and ``energy_only_torch``. The
source is compiled with ``nvcc`` for ``sm_90a`` and ``-fmad=false`` (the
kernel follows torch's rounding operator by operator up to the order of
its sums) at first use (``kernels/cuda_build.py``) and bound with
``ctypes``. Nothing is
compiled or loaded at import.

``LAUNCHES`` counts kernel launches (``PER_EVALUATION`` an evaluation); it
is incremented, under a lock (the tracking and the mapping thread both
launch), only where a kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import numpy as np
import torch

from ldso_tpu_torch.ba.residuals import BASystem
from ldso_tpu_torch.kernels import cuda_build

SOURCE = cuda_build.csrc(__file__, "ba.cu")
NO_FMAD = ("-fmad=false",)      # no contraction into FMA
MAX_SLOTS = 32                  # kMaxSlots of the source
PER_EVALUATION = 2              # ba_linearize, then ba_reduce
PAIR_TABLE = 62                 # kPairTable: a [host, target] entry of the pair table
# the per-point record (kPairWords / kPointWords of the source): per target
# slot f, at f * PAIR_WORDS, the pair's sums over its 8 pattern points
# (weighted products of the rows target8, host8, cam4 and the residual):
# TT the upper triangle of target8 target8^T, HT host8 target8^T (row-major),
# TC target8 cam4^T, BT target8 r; then at F * PAIR_WORDS the point's sums
# over all its samples: HH (upper triangle), HC, BH, CC (upper triangle), BC,
# the energy and the count of valid samples
PAIR_WORDS = 140
TT, HT, TC, BT = 0, 36, 100, 132
POINT_WORDS = 92
HH, HC, BH, CC, BC, ENERGY, COUNT = 0, 36, 68, 76, 86, 90, 91
TABLE_WORDS = 12                # kTableWords: a row of reduce_table
SUM, INTEGER = 0, 1             # a row's kind: a float sum, the integer count
ALWAYS, UNUSED = -1, -2         # a term's condition besides "host == slot"

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


def build() -> str:
    """Compile csrc/ba.cu if need be; the library path."""
    return cuda_build.build(SOURCE, extra=NO_FMAD)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE, extra=NO_FMAD)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # images, H, W, F, frame_valid, pair, slot, c, c_zero, P, p_valid,
    # p_host, p_uv, p_color, p_weight, p_idepth, p_idepth_zero, res_mask,
    # delta, huber, outlier_sum, energy_only, record, H_xd, H_dd, b_d,
    # e_pair, valid_pair, oob_pair, stream
    lib.ldso_ba_linearize.argtypes = ([p, i, i, i] + [p] * 5 + [i] + [p] * 9 + [f, f, i]
                                      + [p] * 7 + [p])
    lib.ldso_ba_linearize.restype = i
    # table, n, P, R, F, record, p_host, out, count, stream
    lib.ldso_ba_reduce.argtypes = [p, i, i, i, i, p, p, p, p, p]
    lib.ldso_ba_reduce.restype = i
    return lib


def record_words(F: int) -> int:
    """Floats of one point's record at F slots."""
    return F * PAIR_WORDS + POINT_WORDS


def _sym(a: int, b: int, n: int) -> int:
    """Index of (a, b), a <= b, in the packed upper triangle of n x n."""
    return a * n - a * (a - 1) // 2 + (b - a)


@functools.lru_cache(maxsize=None)
def reduce_table(F: int) -> np.ndarray:
    """int32 [n, TABLE_WORDS]: how ``ba_reduce`` makes each entry of the
    system at F slots (D = 8F + 4) from the points' records. A row:
    kind (SUM or INTEGER), out0, out1 (flat indices into the output: H
    row-major at 0, b at D*D, the energy at D*D + D; out1 the mirrored
    entry of H, or -1), then four terms (condition, record word): the word
    counts for a point when the condition is ALWAYS or equals the point's
    host slot; UNUSED terms count never. A point's terms are added in
    order, the points in point order. The rows: the frame blocks of H
    (x <= y; within a diagonal block a <= b), the frame-intrinsics blocks,
    the intrinsics block (i <= j), b, the energy, the count."""
    D = 8 * F + 4
    pt = F * PAIR_WORDS
    rows = []

    def row(out0, out1, *terms, kind=SUM):
        terms = list(terms) + [(UNUSED, 0)] * (4 - len(terms))
        rows.append([kind, out0, out1] + [v for t in terms for v in t] + [0])

    for x in range(F):
        for y in range(x, F):
            for a in range(8):
                for b in range(a if x == y else 0, 8):
                    i, j = 8 * x + a, 8 * y + b
                    mirror = j * D + i if i != j else -1
                    if x == y:
                        row(i * D + j, mirror, (ALWAYS, x * PAIR_WORDS + TT + _sym(a, b, 8)),
                            (x, pt + HH + _sym(a, b, 8)),
                            (x, x * PAIR_WORDS + HT + 8 * a + b),
                            (x, x * PAIR_WORDS + HT + 8 * b + a))
                    else:
                        row(i * D + j, mirror, (x, y * PAIR_WORDS + HT + 8 * a + b),
                            (y, x * PAIR_WORDS + HT + 8 * b + a))
    for x in range(F):
        for a in range(8):
            for j in range(4):
                r, c = 8 * x + a, 8 * F + j
                row(r * D + c, c * D + r, (ALWAYS, x * PAIR_WORDS + TC + 4 * a + j),
                    (x, pt + HC + 4 * a + j))
    for i in range(4):
        for j in range(i, 4):
            r, c = 8 * F + i, 8 * F + j
            row(r * D + c, c * D + r if i != j else -1, (ALWAYS, pt + CC + _sym(i, j, 4)))
    for x in range(F):
        for a in range(8):
            row(D * D + 8 * x + a, -1, (ALWAYS, x * PAIR_WORDS + BT + a), (x, pt + BH + a))
    for j in range(4):
        row(D * D + 8 * F + j, -1, (ALWAYS, pt + BC + j))
    row(D * D + D, -1, (ALWAYS, pt + ENERGY))
    row(-1, -1, (ALWAYS, pt + COUNT), kind=INTEGER)
    return np.asarray(rows, dtype=np.int32)


@functools.lru_cache(maxsize=1)
def energy_table() -> np.ndarray:
    """``reduce_table``'s counterpart for ``energy_only``: a record of two
    words (the energy, the count); the energy to output 0."""
    return np.asarray([[SUM, 0, -1, ALWAYS, 0] + [UNUSED, 0] * 3 + [0],
                       [INTEGER, -1, -1, ALWAYS, 1] + [UNUSED, 0] * 3 + [0]], dtype=np.int32)


_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()


def _device_table(F: Optional[int], dev: torch.device) -> torch.Tensor:
    """The reduce table (``energy_table`` for F None) on ``dev``, made once."""
    key = (F, str(dev))
    with _TABLES_LOCK:
        t = _TABLES.get(key)
        if t is None:
            host = energy_table() if F is None else reduce_table(F)
            t = _TABLES[key] = torch.as_tensor(host, device=dev)
    return t


def _check(name: str, t: torch.Tensor, dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"BA kernel: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"BA kernel: {name} has shape {tuple(t.shape)}, not {shape}")
    if not t.is_contiguous():
        raise ValueError(f"BA kernel: {name} is not contiguous")


def _inputs(win, pair, slot) -> tuple:
    """Check the window's fields and the tables; (device, F, P, H, W)."""
    dev = win.images.device
    for name, t in (("pair", pair), ("slot", slot), *zip(win._fields, win)):
        if t.device != dev:
            raise ValueError(f"BA kernel: tensors on {dev} and {t.device} ({name})")
    if win.images.ndim != 4 or win.images.shape[3] != 3:
        raise ValueError(f"BA kernel: images has shape {tuple(win.images.shape)}, "
                         f"not [F, H, W, 3]")
    F, h, w = win.images.shape[0], win.images.shape[1], win.images.shape[2]
    P = win.p_uv.shape[0]
    if not 1 <= F <= MAX_SLOTS:
        raise ValueError(f"BA kernel: {F} slots, 1..{MAX_SLOTS}")
    f32, b8 = torch.float32, torch.bool
    for name, t, dt, shape in (
            ("images", win.images, f32, (F, h, w, 3)), ("frame_valid", win.frame_valid, b8, (F,)),
            ("c", win.c, f32, (4,)), ("c_zero", win.c_zero, f32, (4,)),
            ("p_valid", win.p_valid, b8, (P,)), ("p_host", win.p_host, torch.int32, (P,)),
            ("p_uv", win.p_uv, f32, (P, 2)), ("p_color", win.p_color, f32, (P, 8)),
            ("p_weight", win.p_weight, f32, (P, 8)), ("p_idepth", win.p_idepth, f32, (P,)),
            ("p_idepth_zero", win.p_idepth_zero, f32, (P,)),
            ("res_mask", win.res_mask, b8, (P, F)), ("pair", pair, f32, (F, F, PAIR_TABLE)),
            ("slot", slot, f32, (F, 3))):
        _check(name, t, dt, shape)
    if dev.type != "cuda":
        raise ValueError(f"BA kernel needs CUDA tensors, got {dev}")
    return dev, F, P, h, w


def _linearize(win, pair, slot, delta, huber_th, outlier_sum, energy_only, record, outs,
               dev, F, P, h, w) -> None:
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ldso_ba_linearize(
            win.images.data_ptr(), h, w, F, win.frame_valid.data_ptr(), pair.data_ptr(),
            slot.data_ptr(), win.c.data_ptr(), win.c_zero.data_ptr(), P,
            win.p_valid.data_ptr(), win.p_host.data_ptr(), win.p_uv.data_ptr(),
            win.p_color.data_ptr(), win.p_weight.data_ptr(), win.p_idepth.data_ptr(),
            win.p_idepth_zero.data_ptr(), win.res_mask.data_ptr(),
            None if delta is None else delta.data_ptr(), float(huber_th), float(outlier_sum),
            int(energy_only), record.data_ptr(),
            *(None if t is None else t.data_ptr() for t in outs), stream)
    if P:                       # no point, no launch
        _count()
    if err != 0:
        raise RuntimeError(f"BA linearize kernel launch failed: cudaError {err}")


def _reduce(table, record, p_host, out, count, dev, F, P) -> None:
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ldso_ba_reduce(table.data_ptr(), table.shape[0], P, record.shape[1], F,
                                 record.data_ptr(), p_host.data_ptr(), out.data_ptr(),
                                 count.data_ptr(), stream)
    _count()
    if err != 0:
        raise RuntimeError(f"BA reduce kernel launch failed: cudaError {err}")


def assemble_cuda(win, pair, slot, huber_th: float, outlier_sum: float,
                  delta: Optional[torch.Tensor] = None) -> BASystem:
    """TWO launches: linearize every residual of ``win`` (``core.window.
    Window``, on the card) and assemble the Gauss-Newton system, as
    ``residuals.assemble_torch``. ``pair`` [F, F, PAIR_TABLE] and ``slot``
    [F, 3] are ``residuals.ba_slot_tables``'; ``delta`` [8F + 4] the state
    delta for mode "fej" (None: mode "active"). Every tensor float32 (the
    masks bool, p_host int32), contiguous, on one CUDA device. Returns a
    ``BASystem`` of fresh tensors (H, b and the energy views of one
    buffer)."""
    dev, F, P, h, w = _inputs(win, pair, slot)
    D = 8 * F + 4
    if delta is not None:
        _check("delta", delta, torch.float32, (D,))
        if delta.device != dev:
            raise ValueError(f"BA kernel: tensors on {dev} and {delta.device} (delta)")
    f32 = dict(dtype=torch.float32, device=dev)
    record = torch.empty((P, record_words(F)), **f32)
    H_xd = torch.empty((P, D), **f32)
    pts = torch.empty((2, P), **f32)
    e_pair = torch.empty((P, F), **f32)
    masks = torch.empty((2, P, F), dtype=torch.bool, device=dev)
    out = torch.empty(D * D + D + 1, **f32)
    count = torch.empty((), dtype=torch.int64, device=dev)
    outs = (H_xd, pts[0], pts[1], e_pair, masks[0], masks[1])
    _linearize(win, pair, slot, delta, huber_th, outlier_sum, False, record, outs,
               dev, F, P, h, w)
    _reduce(_device_table(F, dev), record, win.p_host, out, count, dev, F, P)
    return BASystem(H=out[:D * D].view(D, D), b=out[D * D:D * D + D], H_xd=H_xd,
                    H_dd=pts[0], b_d=pts[1], energy=out[D * D + D], e_pair=e_pair,
                    valid_pair=masks[0], oob_pair=masks[1], num_res=count)


def energy_only_cuda(win, pair, slot, huber_th: float, outlier_sum: float) -> tuple:
    """TWO launches: ``residuals.energy_only_torch`` on the card: (the
    total Huber energy, float32, and the count of valid residuals, int64),
    0-dim fresh tensors. Arguments as ``assemble_cuda``'s."""
    dev, F, P, h, w = _inputs(win, pair, slot)
    record = torch.empty((P, 2), dtype=torch.float32, device=dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    _linearize(win, pair, slot, None, huber_th, outlier_sum, True, record,
               (None,) * 6, dev, F, P, h, w)
    _reduce(_device_table(None, dev), record, win.p_host, out, count, dev, F, P)
    return out[0], count
