"""CUDA kernel for the windowed BA's linearization (K4): counterpart of the
XLA program of the JAX package's ``ba/residuals.assemble`` (with its
``precompute_pairs``) and of its ``energy_only``; the JAX package has no
Pallas source for either.

The kernel source is ``ldso_tpu_torch/csrc/ba.cu``. An evaluation is ONE
launch: it makes the pair tables from the window's poses and affine states
(``residuals.ba_slot_tables``' values, bit for bit), linearizes every
residual (a warp a (point, pass of 4 target slots), 8 pattern points on the
lanes of each slot group), writes every per-point output (``H_xd``,
``H_dd``, ``b_d``, ``e_pair``, the masks) and sums the reduced camera
system: a partial system a CTA, each entry owned by one thread and summed
over the CTA's tasks by the terms ``index_table`` gives it, then the
partials added in CTA order (a group's last CTA adds its group's, the last
group the groups'), so that a second launch on the same inputs gives the
same bits. ``energy_only_cuda`` is the same launch without the Jacobians.
``residuals.assemble`` and ``residuals.energy_only`` dispatch here for CUDA
tensors; the plain versions are ``residuals.assemble_torch`` and
``energy_only_torch``. The source is compiled with ``nvcc`` for ``sm_90a``
and ``-fmad=false`` (the kernel follows torch's rounding operator by
operator up to the order of its sums) at first use
(``kernels/cuda_build.py``) and bound with ``ctypes``. Nothing is compiled
or loaded at import.

``LAUNCHES`` counts kernel launches (``PER_EVALUATION`` an evaluation); it
is incremented, under a lock (the tracking and the mapping thread both
launch), only where the kernel is launched.
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
PER_EVALUATION = 1              # one launch an evaluation
WARPS = 16                      # kWarps: a CTA's warps, the tasks of a tile
GROUP_SIZE = 16                 # kGroupSize: the CTAs whose partials one CTA adds
PAIR_TABLE = 62                 # kPairTable: a [host, target] entry of the pair table
MODES = {"active": 0, "fej": 1, "energy": 2}
# a pair's words (kGW of the source), the sums over its 8 pattern points: TT
# the upper triangle of w target8 target8^T, HT w host8 target8^T
# (row-major), TC w target8 cam4^T, BT target8 w r, HX target8 w d, the
# energy
GROUP_WORDS = 149
TT, HT, TC, BT, HX, GE = 0, 36, 100, 132, 140, 148
# a task's point words (kPW), the sums over its 32 samples: HH (upper
# triangle), HC, BH, CC (upper triangle), BC, the energy, the count, HXH
# host8 w d, HXC cam4 w d, H_dd, b_d
POINT_WORDS = 106
HH, HC, BH, CC, BC, PE, PN, HXH, HXC, HDD, BD = 0, 36, 68, 76, 86, 90, 91, 92, 100, 104, 105
TABLE_WORDS = 8                 # kTableWords: a row of index_table
SRC_POINT, ALWAYS = 32, 32      # a term's point source; its condition "always"

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
    # images, H, W, F, frame_valid, T_eval, x, x_zero, exposure, c, c_zero,
    # P, p_valid, p_host, p_uv, p_color, p_weight, p_idepth, p_idepth_zero,
    # res_mask, huber, outlier_sum, mode, table, n, out_entry, n_out, sys,
    # H_xd, H_dd, b_d, e_pair, count, valid_pair, oob_pair, part, gpart,
    # counters, debug, grid, stream
    lib.ldso_ba_assemble.argtypes = ([p, i, i, i] + [p] * 7 + [i] + [p] * 8
                                     + [f, f, i, p, i, p, i] + [p] * 12 + [i, p])
    lib.ldso_ba_assemble.restype = i
    for name in ("ldso_ba_threads", "ldso_ba_group_size"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = []
    if (lib.ldso_ba_threads(), lib.ldso_ba_group_size()) != (32 * WARPS, GROUP_SIZE):
        raise RuntimeError("BA kernel: csrc/ba.cu's kWarps / kGroupSize differ from kernels/ba.py")
    return lib


def entries(F: int) -> int:
    """Entries of the partial system at F slots (D = 8F + 4): the upper
    triangle of H, b, the energy and the count."""
    D = 8 * F + 4
    return D * (D + 1) // 2 + D + 2


def _sym(a: int, b: int, n: int) -> int:
    """Index of (a, b), a <= b, in the packed upper triangle of n x n."""
    return a * n - a * (a - 1) // 2 + (b - a)


def term(src: int, word: int, cond: int = ALWAYS) -> int:
    """A term of ``index_table``: ``word`` of the pair of target slot ``src``
    (or of the point words, ``src`` SRC_POINT), counted for a task whose
    point's host slot is ``cond`` (or always)."""
    return word | src << 8 | cond << 16


@functools.lru_cache(maxsize=None)
def index_table(F: int) -> np.ndarray:
    """int32 [entries(F), TABLE_WORDS]: how the kernel makes each entry of
    the system at F slots (D = 8F + 4) from its tasks' words. A row: four
    terms (``term``; -1 unused), added for each task in task order, term
    by term; then out0, out1 (flat indices into the output: H row-major at
    0, b at D*D, the energy at D*D + D; out1 the mirrored entry of H, or
    -1; out0 -1 for the count; the kernel reads them through
    ``output_entries``), two words of padding. The rows: the frame
    blocks of H (x <= y; within a diagonal block a <= b), the
    frame-intrinsics blocks, the intrinsics block (i <= j), b, the energy,
    the count."""
    D = 8 * F + 4
    rows = []

    def row(out0, out1, *terms):
        rows.append(list(terms) + [-1] * (4 - len(terms)) + [out0, out1, 0, 0])

    for x in range(F):
        for y in range(x, F):
            for a in range(8):
                for b in range(a if x == y else 0, 8):
                    i, j = 8 * x + a, 8 * y + b
                    mirror = j * D + i if i != j else -1
                    if x == y:
                        row(i * D + j, mirror, term(x, TT + _sym(a, b, 8)),
                            term(SRC_POINT, HH + _sym(a, b, 8), x), term(x, HT + 8 * a + b, x),
                            term(x, HT + 8 * b + a, x))
                    else:
                        row(i * D + j, mirror, term(y, HT + 8 * a + b, x),
                            term(x, HT + 8 * b + a, y))
    for x in range(F):
        for a in range(8):
            for j in range(4):
                r, c = 8 * x + a, 8 * F + j
                row(r * D + c, c * D + r, term(x, TC + 4 * a + j),
                    term(SRC_POINT, HC + 4 * a + j, x))
    for i in range(4):
        for j in range(i, 4):
            r, c = 8 * F + i, 8 * F + j
            row(r * D + c, c * D + r if i != j else -1, term(SRC_POINT, CC + _sym(i, j, 4)))
    for x in range(F):
        for a in range(8):
            row(D * D + 8 * x + a, -1, term(x, BT + a), term(SRC_POINT, BH + a, x))
    for j in range(4):
        row(D * D + 8 * F + j, -1, term(SRC_POINT, BC + j))
    row(D * D + D, -1, term(SRC_POINT, PE))
    row(-1, -1, term(SRC_POINT, PN))
    return np.asarray(rows, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def output_entries(F: Optional[int]) -> np.ndarray:
    """int32 [D*D + D + 1]: the entry of ``index_table(F)`` each output
    (H row-major, b, the energy) takes, from its out0 / out1 columns (F
    None: ``energy_table``'s one output)."""
    t = energy_table() if F is None else index_table(F)
    D = 8 * (F or 0) + 4
    out = np.full(1 if F is None else D * D + D + 1, -1, dtype=np.int32)
    for col in (4, 5):
        rows = np.nonzero(t[:, col] >= 0)[0]
        out[t[rows, col]] = rows
    return out


@functools.lru_cache(maxsize=1)
def energy_table() -> np.ndarray:
    """``index_table``'s counterpart for ``energy_only``: the energy (to
    output 0) and the count."""
    return np.asarray([[term(SRC_POINT, PE), -1, -1, -1, 0, -1, 0, 0],
                       [term(SRC_POINT, PN), -1, -1, -1, -1, -1, 0, 0]], dtype=np.int32)


def passes(slots: int) -> int:
    """Passes a point takes with ``slots`` valid target slots (4 a pass)."""
    return max((slots + 3) // 4, 1)


def grid_size(P: int, F: int, sms: int) -> int:
    """CTAs of a launch: one a tile (WARPS // passes points) at the most
    passes F slots can take, at most one an SM."""
    npt = WARPS // passes(F)
    return max(1, min(sms, -(-P // npt)))


_CACHE: dict = {}
_CACHE_LOCK = threading.RLock()


def _cached(key, make):
    with _CACHE_LOCK:
        t = _CACHE.get(key)
        if t is None:
            t = _CACHE[key] = make()
    return t


def _sms(dev: torch.device) -> int:
    return _cached(("sms", dev.index),
                   lambda: torch.cuda.get_device_properties(dev).multi_processor_count)


def _tables(F: Optional[int], dev: torch.device) -> tuple:
    """The index table and the output entries (``energy_table``'s for F
    None) on ``dev``, made once."""
    return _cached(("table", F, dev.index), lambda: (
        torch.as_tensor(energy_table() if F is None else index_table(F), device=dev),
        torch.as_tensor(output_entries(F), device=dev)))


def _scratch(F: int, dev: torch.device, stream: int) -> tuple:
    """The partials (one a CTA, one a group) and the counters for launches
    at F slots on ``stream``, made once (the counters zero; every launch
    leaves them zero)."""
    def make():
        sms, n4 = _sms(dev), -(-entries(F) // 4) * 4          # rows of whole float4s
        groups = -(-sms // GROUP_SIZE)
        return (torch.empty(sms * n4, dtype=torch.float32, device=dev),
                torch.empty(groups * n4, dtype=torch.float32, device=dev),
                torch.zeros(groups + 1, dtype=torch.int32, device=dev))
    return _cached(("scratch", F, dev.index, stream), make)


@functools.lru_cache(maxsize=64)
def _spec(F: int, P: int, h: int, w: int) -> tuple:
    """(dtype, shape) of each field of a ``core.window.Window``, in order."""
    f32, b8 = torch.float32, torch.bool
    return ((b8, (F,)), (f32, (F, 4, 4)), (f32, (F, 8)), (f32, (F, 8)), (f32, (F,)),
            (f32, (F, h, w, 3)), (f32, (4,)), (f32, (4,)), (b8, (P,)), (torch.int32, (P,)),
            (f32, (P, 2)), (f32, (P, 8)), (f32, (P, 8)), (f32, (P,)), (f32, (P,)), (b8, (P, F)))


def _explain(win) -> None:
    """Raise for what ``_inputs`` refused: tensors on two devices, a wrong
    dtype, shape or layout, or tensors off the card."""
    dev = win.images.device
    for name, t in zip(win._fields, win):
        if t.device != dev:
            raise ValueError(f"BA kernel: tensors on {dev} and {t.device} ({name})")
    if win.images.ndim != 4 or win.images.shape[3] != 3:
        raise ValueError(f"BA kernel: images has shape {tuple(win.images.shape)}, "
                         f"not [F, H, W, 3]")
    F, h, w = win.images.shape[:3]
    if not 1 <= F <= MAX_SLOTS:
        raise ValueError(f"BA kernel: {F} slots, 1..{MAX_SLOTS}")
    for name, t, (dt, shape) in zip(win._fields, win, _spec(F, win.p_uv.shape[0], h, w)):
        if t.dtype != dt:
            raise TypeError(f"BA kernel: {name} is {t.dtype}, not {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"BA kernel: {name} has shape {tuple(t.shape)}, not {shape}")
        if not t.is_contiguous():
            raise ValueError(f"BA kernel: {name} is not contiguous")
    raise ValueError(f"BA kernel needs CUDA tensors, got {dev}")


def _inputs(win) -> tuple:
    """Check the window's fields against one spec (dtype, shape, one CUDA
    device, contiguous); (device, F, P, H, W)."""
    img = win.images
    if img.ndim != 4 or not 1 <= img.shape[0] <= MAX_SLOTS:
        _explain(win)
    F, h, w = img.shape[0], img.shape[1], img.shape[2]
    P = win.p_uv.shape[0]
    di = img.get_device()
    if di < 0:
        _explain(win)
    for t, (dt, shape) in zip(win, _spec(F, P, h, w)):
        if t.dtype != dt or t.shape != shape or t.get_device() != di or not t.is_contiguous():
            _explain(win)
    return img.device, F, P, h, w


def _launch(win, huber_th, outlier_sum, mode, tables, ptrs, debug, dev, F, P, h, w) -> None:
    table, out_entry = tables
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        part, gpart, counters = _scratch(F, dev, stream)
        err = lib.ldso_ba_assemble(
            win.images.data_ptr(), h, w, F, win.frame_valid.data_ptr(), win.T_eval.data_ptr(),
            win.x.data_ptr(), win.x_zero.data_ptr(), win.exposure.data_ptr(), win.c.data_ptr(),
            win.c_zero.data_ptr(), P, win.p_valid.data_ptr(), win.p_host.data_ptr(),
            win.p_uv.data_ptr(), win.p_color.data_ptr(), win.p_weight.data_ptr(),
            win.p_idepth.data_ptr(), win.p_idepth_zero.data_ptr(), win.res_mask.data_ptr(),
            float(huber_th), float(outlier_sum), MODES[mode], table.data_ptr(), table.shape[0],
            out_entry.data_ptr(), out_entry.shape[0], *ptrs,
            part.data_ptr(), gpart.data_ptr(), counters.data_ptr(),
            None if debug is None else debug.data_ptr(), grid_size(P, F, _sms(dev)), stream)
    _count()
    if err != 0:
        raise RuntimeError(f"BA kernel launch failed: cudaError {err}")


def assemble_cuda(win, huber_th: float, outlier_sum: float, mode: str = "active",
                  pair_debug: Optional[torch.Tensor] = None) -> BASystem:
    """ONE launch: the pair tables, every residual of ``win``
    (``core.window.Window``, on the card) and the Gauss-Newton system, as
    ``residuals.assemble_torch`` in ``mode`` ("active", or "fej": residuals
    transported by the state's offset from its FEJ point). Every field
    float32 (the masks bool, p_host int32), contiguous, on one CUDA device.
    Returns a ``BASystem`` of fresh tensors (the float outputs views of one
    buffer, the count and the masks of another). ``pair_debug``, a float32
    tensor of F*F*PAIR_TABLE + 3F on the card, receives the pair and slot
    tables the kernel made (``slot_tables_cuda``)."""
    if mode not in ("active", "fej"):
        raise ValueError(f"unknown assemble mode {mode!r}")
    dev, F, P, h, w = _inputs(win)
    D, PF = 8 * F + 4, P * F
    o_hxd = -(-(D * D + D + 1) // 4) * 4
    o_hdd = o_hxd + P * D
    buf = torch.empty(o_hdd + 2 * P + PF, dtype=torch.float32, device=dev)
    flags = torch.empty(8 + 2 * PF, dtype=torch.uint8, device=dev)
    H_xd = buf[o_hxd:o_hdd].view(P, D)
    H_dd, b_d = buf[o_hdd:o_hdd + P], buf[o_hdd + P:o_hdd + 2 * P]
    e_pair = buf[o_hdd + 2 * P:].view(P, F)
    masks = flags[8:].view(torch.bool).view(2, P, F)
    count = flags[:8].view(torch.int64)
    ptrs = [buf.data_ptr(), H_xd.data_ptr(), H_dd.data_ptr(), b_d.data_ptr(), e_pair.data_ptr(),
            count.data_ptr(), masks[0].data_ptr(), masks[1].data_ptr()]
    _launch(win, huber_th, outlier_sum, mode, _tables(F, dev), ptrs, pair_debug, dev, F, P, h, w)
    return BASystem(H=buf[:D * D].view(D, D), b=buf[D * D:D * D + D], H_xd=H_xd, H_dd=H_dd,
                    b_d=b_d, energy=buf[D * D + D], e_pair=e_pair, valid_pair=masks[0],
                    oob_pair=masks[1], num_res=count[0])


def energy_only_cuda(win, huber_th: float, outlier_sum: float) -> tuple:
    """ONE launch: ``residuals.energy_only_torch`` on the card: (the total
    Huber energy, float32, and the count of valid residuals, int64), 0-dim
    fresh tensors. Arguments as ``assemble_cuda``'s."""
    dev, F, P, h, w = _inputs(win)
    buf = torch.empty(16, dtype=torch.uint8, device=dev)
    count, energy = buf[:8].view(torch.int64), buf[8:12].view(torch.float32)
    ptrs = [energy.data_ptr(), None, None, None, None, count.data_ptr(), None, None]
    _launch(win, huber_th, outlier_sum, "energy", _tables(None, dev), ptrs, None, dev, F, P, h, w)
    return energy[0], count[0]


def slot_tables_cuda(win) -> tuple:
    """The pair table [F, F, PAIR_TABLE] and the slot table [F, 3] as the
    kernel makes them (one assemble launch's debug output), in
    ``residuals.ba_slot_tables``' layout."""
    F = win.images.shape[0]
    out = torch.empty(F * F * PAIR_TABLE + 3 * F, dtype=torch.float32, device=win.images.device)
    assemble_cuda(win, 9.0, 2500.0, pair_debug=out)
    return out[:F * F * PAIR_TABLE].view(F, F, PAIR_TABLE), out[F * F * PAIR_TABLE:].view(F, 3)
