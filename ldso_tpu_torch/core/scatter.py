"""Row scatter that drops out-of-range indices.

The reference pads slot vectors with the capacity index and relies on
``x.at[idx].set(v, mode="drop")`` to discard those writes. Torch
indexing would raise (CPU) or assert (CUDA) on them, so the scatter goes
into a buffer one row longer, every out-of-range index is redirected to
that spare row, and the spare row is sliced off. No host sync, no
data-dependent shapes.
"""

from __future__ import annotations

import torch


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Out-of-place ``dst[idx] = val`` along dim 0, dropping idx outside
    [0, len(dst)). ``val`` broadcasts against ``dst[idx]``."""
    n = dst.shape[0]
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    buf = torch.cat([dst, dst[:1]], dim=0)
    if torch.is_tensor(val):
        val = val.to(dst.dtype)
    buf[idx] = val
    return buf[:n]
