"""Device-resident immature (candidate) point bank.

Port of ``ldso_tpu/core/bank.py``: one flat fixed-capacity
struct-of-arrays that lives on the device so the per-frame epipolar
trace updates it without a host round trip. Functions are out-of-place,
as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ldso_tpu_torch import trace as trace_mod
from ldso_tpu_torch.core.scatter import scatter_drop


class Bank(NamedTuple):
    """Immature-point store (capacity N, device-resident)."""

    valid: torch.Tensor          # bool [N]
    host_slot: torch.Tensor      # i32 [N] window slot of host keyframe
    uv: torch.Tensor             # f32 [N, 2] pixel in host frame
    color: torch.Tensor          # f32 [N, 8] host pattern intensities
    weight: torch.Tensor         # f32 [N, 8] static gradient weights
    idepth_min: torch.Tensor     # f32 [N]
    idepth_max: torch.Tensor     # f32 [N]  (NaN = never traced)
    quality: torch.Tensor        # f32 [N] best/second-best trace ratio
    last_status: torch.Tensor    # i32 [N] last trace status
    outlier_count: torch.Tensor  # i32 [N] consecutive-outlier strikes
    is_corner: torch.Tensor      # bool [N] corner-seeded candidate

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


def empty_bank(capacity: int, device) -> Bank:
    n = capacity
    f32, i32 = torch.float32, torch.int32
    return Bank(
        valid=torch.zeros(n, dtype=torch.bool, device=device),
        host_slot=torch.zeros(n, dtype=i32, device=device),
        uv=torch.zeros((n, 2), dtype=f32, device=device),
        color=torch.zeros((n, 8), dtype=f32, device=device),
        weight=torch.ones((n, 8), dtype=f32, device=device),
        idepth_min=torch.zeros(n, dtype=f32, device=device),
        idepth_max=torch.full((n,), float("nan"), dtype=f32, device=device),
        quality=torch.zeros(n, dtype=f32, device=device),
        last_status=torch.full((n,), trace_mod.UNINITIALIZED, dtype=i32, device=device),
        outlier_count=torch.zeros(n, dtype=i32, device=device),
        is_corner=torch.zeros(n, dtype=torch.bool, device=device),
    )


def to_host(bank: Bank) -> Bank:
    """Host snapshot: the same fields as numpy arrays."""
    return Bank(*(a.cpu().numpy() for a in bank))


def from_host(hb: Bank, device) -> Bank:
    """Device bank from a host snapshot (numpy arrays, see :func:`to_host`)."""
    f32, i32 = torch.float32, torch.int32
    dtypes = dict(valid=torch.bool, host_slot=i32, uv=f32, color=f32, weight=f32,
                  idepth_min=f32, idepth_max=f32, quality=f32, last_status=i32,
                  outlier_count=i32, is_corner=torch.bool)
    return Bank(**{f: torch.as_tensor(getattr(hb, f), dtype=dtypes[f], device=device)
                   for f in Bank._fields})


def apply_patch(bank: Bank, drop_mask, seed_slots, seed_uv, seed_color,
                seed_weight, seed_host_slot, seed_is_corner) -> Bank:
    """Drop rows, then scatter fresh seeds into free slots (``seed_slots``
    padded with the capacity index, whose writes are dropped). Seeds
    start with interval [0, NaN), UNINITIALIZED, zero quality/strikes."""
    sl = seed_slots
    return Bank(
        valid=scatter_drop(bank.valid & ~drop_mask, sl, True),
        host_slot=scatter_drop(bank.host_slot, sl, seed_host_slot),
        uv=scatter_drop(bank.uv, sl, seed_uv),
        color=scatter_drop(bank.color, sl, seed_color),
        weight=scatter_drop(bank.weight, sl, seed_weight),
        idepth_min=scatter_drop(bank.idepth_min, sl, 0.0),
        idepth_max=scatter_drop(bank.idepth_max, sl, float("nan")),
        quality=scatter_drop(bank.quality, sl, 0.0),
        last_status=scatter_drop(bank.last_status, sl, trace_mod.UNINITIALIZED),
        outlier_count=scatter_drop(bank.outlier_count, sl, 0),
        is_corner=scatter_drop(bank.is_corner, sl, seed_is_corner),
    )


def drop_rows(bank: Bank, mask) -> Bank:
    """Invalidate rows."""
    return bank._replace(valid=bank.valid & ~mask)


def drop_hosted(bank: Bank, dying_mask) -> Bank:
    """Invalidate candidates hosted by dying window slots (``dying_mask`` [F])."""
    return bank._replace(valid=bank.valid & ~dying_mask[bank.host_slot.long()])
