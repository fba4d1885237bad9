"""Binary-descriptor matching as matmuls.

Port of ``ldso_tpu/loop/match.py``: with bits unpacked to {0,1}
vectors, the full N×M Hamming distance matrix is
    d(a, b) = Σa + Σb − 2·a·bᵀ
— one matmul instead of per-pair popcount loops. Mutual nearest + Lowe
ratio gating are elementwise postprocessing.

The products of {0,1} vectors are exact in float32 only while TF32 is
off; the package sets that once on import (``ldso_tpu_torch/__init__``)
and nothing here changes it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ldso_tpu_torch.loop.orb import unpack_bits


class Matches(NamedTuple):
    idx_b: torch.Tensor      # i32 [N] best match in B for each A feature
    dist: torch.Tensor       # f32 [N] Hamming distance of best match
    valid: torch.Tensor      # bool [N] passed ratio + mutual + threshold


def hamming_matrix(desc_a, desc_b):
    """u8 [N, 32] x u8 [M, 32] -> f32 [N, M] Hamming distances."""
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    ab = a @ b.T
    sa = torch.sum(a, dim=-1, keepdim=True)
    sb = torch.sum(b, dim=-1, keepdim=True)
    return sa + sb.T - 2.0 * ab


def match(desc_a, valid_a, desc_b, valid_b,
          max_dist: float = 64.0, ratio: float = 0.75) -> Matches:
    """Mutual-nearest Hamming matching with Lowe ratio test
    (reference: FeatureMatcher::SearchBruteForce + DistanceThreshold).
    Ties go to the lower index (torch.argmin returns the first minimum,
    as jnp.argmin does)."""
    d = hamming_matrix(desc_a, desc_b)
    big = torch.full_like(d, 1e9)
    d = torch.where(valid_a[:, None] & valid_b[None, :], d, big)

    best_b = torch.argmin(d, dim=1)                               # [N]
    best_d = torch.amin(d, dim=1)
    # second best for ratio test
    rows = torch.arange(d.shape[0], device=d.device)
    d2 = d.clone()
    d2[rows, best_b] = 1e9
    second_d = torch.amin(d2, dim=1)
    # mutual check
    best_a_of_b = torch.argmin(d, dim=0)                          # [M]
    mutual = best_a_of_b[best_b] == rows

    ok = (best_d <= max_dist) & (best_d < ratio * second_d) & mutual & valid_a
    return Matches(idx_b=best_b.to(torch.int32), dist=best_d, valid=ok)
