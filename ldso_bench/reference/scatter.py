"""[The benchmark's reference: a frozen copy of the port's module of the
same name as of its first benchmark. Every dispatcher here calls the plain
torch version on any device; where the text below speaks of kernels, it
describes the port it was copied from.]

Row scatters: one that drops out-of-range indices, and a sum into
segments in a fixed order.

The reference pads slot vectors with the capacity index and relies on
``x.at[idx].set(v, mode="drop")`` to discard those writes. Torch
indexing would raise (CPU) or assert (CUDA) on them, so the scatter goes
into a buffer one row longer, every out-of-range index is redirected to
that spare row, and the spare row is sliced off. No host sync, no
data-dependent shapes.

``SegmentSum`` replaces ``zeros(n).index_add(0, idx, rows)`` where the
result must repeat bit for bit: on the card ``index_add`` adds with
atomics in no fixed order, so a float32 pose graph solved twice gave two
energies. The rows are sorted by index once per graph (stable), and
``torch.segment_reduce`` sums each segment in that order.
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


class SegmentSum:
    """``zeros(n, ...).index_add(0, idx, rows)`` summed in a fixed order:
    the order of ``idx`` itself within each target row. Built once per
    index vector; each call sorts the rows and sums the segments."""

    def __init__(self, idx: torch.Tensor, n: int):
        idx = idx.long()
        self.order = torch.argsort(idx, stable=True)
        bounds = torch.searchsorted(idx[self.order],
                                    torch.arange(n + 1, dtype=idx.dtype, device=idx.device))
        self.lengths = torch.diff(bounds)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(rows[self.order], "sum", lengths=self.lengths, axis=0)
