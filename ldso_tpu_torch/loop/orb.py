"""Corner detection + oriented binary descriptors (ORB-style).

Port of ``ldso_tpu/loop/orb.py``. Everything is dense map computation
over one level-0 image:
  * FAST-16 corner score via 16 rolled copies of the image and a
    doubled-mask contiguous-arc test,
  * Shi-Tomasi min-eigenvalue score via box-filtered structure tensors,
  * per-cell argmax grid selection to a fixed feature capacity,
  * intensity-centroid orientation + rotated-BRIEF sampling as batched
    bilinear gathers.

The 256 BRIEF sampling pairs are generated once from a fixed seed with
numpy, exactly as the reference does (``BRIEF_PAIRS`` is a copy, pinned
to the original by the package tests).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ldso_tpu_torch.kernels.interp import bilinear

# FAST-16 Bresenham circle of radius 3 (du, dv)
FAST_OFFSETS = np.asarray([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)

PATCH_R = 15          # orientation patch radius (ORB uses 15)
DESC_BITS = 256
DESC_BYTES = 32


def _brief_pairs(seed: int = 7) -> np.ndarray:
    """[256, 4] (x1, y1, x2, y2) Gaussian sampling pairs in a 31x31 patch."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_R + 1) / 5.0
    p = rng.normal(0.0, sigma, size=(DESC_BITS, 4))
    return np.clip(p, -PATCH_R, PATCH_R).astype(np.float32)


BRIEF_PAIRS = _brief_pairs()


class Features(NamedTuple):
    uv: torch.Tensor        # f32 [N, 2]
    score: torch.Tensor     # f32 [N]
    angle: torch.Tensor     # f32 [N] radians
    desc: torch.Tensor      # u8 [N, 32] packed 256-bit descriptor
    valid: torch.Tensor     # bool [N]


def _arc_score(mask, mag):
    """Best 9-contiguous arc: max over the 16 arc starts of the arc's
    min |I_c − I_p| where every sample of the arc passes ``mask``."""
    m2 = torch.cat([mask, mask], dim=-1)                       # [H, W, 32]
    g2 = torch.cat([mag, mag], dim=-1)
    best = torch.zeros(mag.shape[:-1], dtype=mag.dtype, device=mag.device)
    for s in range(16):
        w_ok = torch.all(m2[..., s:s + 9], dim=-1)
        w_min = torch.amin(g2[..., s:s + 9], dim=-1)
        best = torch.maximum(best, torch.where(w_ok, w_min, torch.zeros_like(w_min)))
    return best


def fast_score(img, threshold: float = 20.0):
    """[H, W] FAST-16 corner score: for pixels with ≥9 contiguous circle
    samples all brighter (or all darker) than center±t, the score is the
    min |I_c − I_p| over the best arc; else 0. The circle wraps around
    the image borders (``torch.roll``, as the reference's ``jnp.roll``)."""
    circ = torch.stack([torch.roll(img, (-int(dv), -int(du)), dims=(0, 1))
                        for du, dv in FAST_OFFSETS], dim=-1)  # [H, W, 16]
    d = circ - img[..., None]
    del circ
    # one [H, W, 16] arc test at a time: at 640x480 each doubled
    # [H, W, 32] f32 temporary is ~39 MB
    bright = _arc_score(d > threshold, d)
    dark = _arc_score(d < -threshold, -d)
    return torch.maximum(bright, dark)


def _box3(x):
    """3x3 box filter. The reference's docstring says "edge clamp", but
    its ``jnp.roll`` wraps around the borders; this matches the code."""
    out = torch.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + torch.roll(x, (dy, dx), dims=(0, 1))
    return out / 9.0


def shi_tomasi_score(dx, dy):
    """[H, W] min eigenvalue of the 3x3-windowed structure tensor."""
    a = _box3(dx * dx)
    b = _box3(dx * dy)
    c = _box3(dy * dy)
    tr = 0.5 * (a + c)
    det = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    return tr - det


def detect(img3, max_features: int = 512, cell: int = 16,
           fast_th: float = 20.0) -> Features:
    """Grid corner detection + descriptors on a level-0 (I, dx, dy) stack
    (reference: FeatureDetector::DetectCorners)."""
    img = img3[..., 0]
    h, w = img.shape
    dev = img.device
    score = fast_score(img, fast_th)
    # Shi-Tomasi fallback so weakly-textured cells still yield corners
    st = shi_tomasi_score(img3[..., 1], img3[..., 2])
    score = torch.where(score > 0, score + 1e3, st / (st.max() + 1e-6))

    # border exclusion: orientation/descriptor patch must fit
    m = PATCH_R + 1
    score[:m, :] = 0
    score[-m:, :] = 0
    score[:, :m] = 0
    score[:, -m:] = 0

    # per-cell argmax (first maximum, as jnp.argmax), then global top-k
    ch, cw = h // cell, w // cell
    s = score[: ch * cell, : cw * cell].reshape(ch, cell, cw, cell)
    s = s.permute(0, 2, 1, 3).reshape(ch, cw, cell * cell)
    cidx = torch.argmax(s, dim=-1)
    cbest = torch.amax(s, dim=-1)
    cy = torch.arange(ch, device=dev)[:, None] * cell + cidx // cell
    cx = torch.arange(cw, device=dev)[None, :] * cell + cidx % cell
    flat_scores = cbest.reshape(-1)
    flat_uv = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)

    # FAST scores are integer differences of uint8 frames, so ties are the
    # rule: jax.lax.top_k puts the lower index first among equal scores,
    # and a stable descending sort does the same (torch.topk promises no
    # order on ties)
    k = min(max_features, flat_scores.shape[0])
    top, idx = torch.sort(flat_scores, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    uv = flat_uv[idx].to(torch.float32)
    valid = top > 0
    if k < max_features:
        pad = max_features - k
        uv = torch.cat([uv, torch.zeros((pad, 2), dtype=uv.dtype, device=dev)])
        top = torch.cat([top, torch.zeros(pad, dtype=top.dtype, device=dev)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=dev)])

    angle = _orientation(img, uv)
    desc = _brief(img, uv, angle)
    return Features(uv=uv, score=top, angle=angle, desc=desc, valid=valid)


def _orientation(img, uv):
    """Intensity-centroid angle (reference: IC_Angle in FeatureDetector)."""
    r = PATCH_R
    ar = torch.arange(-r, r + 1, device=img.device)
    ys, xs = torch.meshgrid(ar, ar, indexing="ij")
    mask = (xs * xs + ys * ys) <= r * r
    pts = uv[:, None, None, :] + torch.stack([xs, ys], dim=-1)[None].to(torch.float32)
    vals = bilinear(img, pts) * mask[None]                       # [N, 2r+1, 2r+1]
    m10 = torch.sum(vals * xs[None], dim=(1, 2))
    m01 = torch.sum(vals * ys[None], dim=(1, 2))
    return torch.atan2(m01, m10)


def _brief(img, uv, angle):
    """Rotated-BRIEF 256-bit descriptor, packed to u8[N, 32]."""
    pairs = torch.as_tensor(BRIEF_PAIRS, device=img.device)      # [256, 4]
    ca, sa = torch.cos(angle), torch.sin(angle)                  # [N]

    def rot(px, py):
        # [N, 256, 2] rotated offsets
        x = ca[:, None] * px[None] - sa[:, None] * py[None]
        y = sa[:, None] * px[None] + ca[:, None] * py[None]
        return torch.stack([x, y], dim=-1)

    p1 = uv[:, None, :] + rot(pairs[:, 0], pairs[:, 1])
    p2 = uv[:, None, :] + rot(pairs[:, 2], pairs[:, 3])
    bits = (bilinear(img, p1) < bilinear(img, p2)).to(torch.uint8)   # [N, 256]
    b = bits.reshape(-1, DESC_BYTES, 8)
    weights = torch.as_tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                              device=img.device)
    return torch.sum(b * weights, dim=-1).to(torch.uint8)


def unpack_bits(desc):
    """u8 [..., 32] -> f32 [..., 256] in {0, 1} (for matmul Hamming)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], DESC_BITS).to(torch.float32)
