"""[The benchmark's reference: a frozen copy of the port's module of the
same name as of its first benchmark. Every dispatcher here calls the plain
torch version on any device; where the text below speaks of kernels, it
describes the port it was copied from.]

Bilinear interpolation gathers over images and (I, dx, dy) stacks.

Port of ``ldso_tpu/kernels/interp.py``. All functions are batched over
arbitrary leading dims of the sample coordinates and clamp out-of-bounds
samples (callers carry a validity mask; see :func:`in_bounds`).

The gathers take an optional ``frame`` index: with a stacked
``[F, H, W, C]`` image and a per-sample frame index, one gather samples
every window frame at once (the reference loops over frames instead).
"""

from __future__ import annotations

import torch


def in_bounds(uv, w: int, h: int, border: float = 1.0):
    """Validity mask for bilinear sampling with a safety border (px)."""
    u, v = uv[..., 0], uv[..., 1]
    return (u >= border) & (u < w - 1 - border) & (v >= border) & (v < h - 1 - border)


def _gather2d(img, iu, iv, frame=None):
    """img [H, W, C] / [H, W] (or [F, H, W, ...] with ``frame``); integer
    index gather with clamping. Indices are int32 and widen at the gather."""
    if frame is None:
        h, w = img.shape[0], img.shape[1]
        flat = img.reshape((h * w,) + tuple(img.shape[2:]))
        base = 0
    else:
        f, h, w = img.shape[0], img.shape[1], img.shape[2]
        flat = img.reshape((f * h * w,) + tuple(img.shape[3:]))
        base = torch.clamp(frame.long(), 0, f - 1) * (h * w)
    iu = torch.clamp(iu, 0, w - 1).long()
    iv = torch.clamp(iv, 0, h - 1).long()
    return flat[base + iv * w + iu]


def bilinear(img, uv, frame=None):
    """Bilinear sample: img [H, W] or [H, W, C], uv [..., 2] -> [...] or [..., C]."""
    u, v = uv[..., 0], uv[..., 1]
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    du = u - u0.to(u.dtype)
    dv = v - v0.to(v.dtype)
    if img.ndim - (0 if frame is None else 1) == 3:
        du = du[..., None]
        dv = dv[..., None]
    p00 = _gather2d(img, u0, v0, frame)
    p10 = _gather2d(img, u0 + 1, v0, frame)
    p01 = _gather2d(img, u0, v0 + 1, frame)
    p11 = _gather2d(img, u0 + 1, v0 + 1, frame)
    top = p00 * (1.0 - du) + p10 * du
    bot = p01 * (1.0 - du) + p11 * du
    return top * (1.0 - dv) + bot * dv


def bilinear33(img3, uv):
    """Sample an (I, dx, dy) stack: img3 [H, W, 3], uv [..., 2] -> [..., 3]."""
    return bilinear(img3, uv)


def pack_corners(img):
    """Pre-pack the 2x2 bilinear footprint: [..., H, W, C] -> [..., H, W, 4C].

    packed[v, u] = concat(img[v, u], img[v, u+1], img[v+1, u],
    img[v+1, u+1]) (border rows/cols replicate); leading dims batch."""
    right = torch.cat([img[..., :, 1:, :], img[..., :, -1:, :]], dim=-2)
    down = torch.cat([img[..., 1:, :, :], img[..., -1:, :, :]], dim=-3)
    down_right = torch.cat([down[..., :, 1:, :], down[..., :, -1:, :]], dim=-2)
    return torch.cat([img, right, down, down_right], dim=-1)


def bilinear_packed(packed, uv, c: int, frame=None):
    """Bilinear sample from a corner-packed image (see pack_corners).

    packed: [H, W, 4C] (or [F, H, W, 4C] with ``frame``); uv: [..., 2].
    Returns [..., C]. One gather per sample instead of four."""
    u, v = uv[..., 0], uv[..., 1]
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    du = (u - u0.to(u.dtype))[..., None]
    dv = (v - v0.to(v.dtype))[..., None]
    corners = _gather2d(packed, u0, v0, frame)
    corners = corners.reshape(corners.shape[:-1] + (4, c))
    top = corners[..., 0, :] * (1.0 - du) + corners[..., 1, :] * du
    bot = corners[..., 2, :] * (1.0 - du) + corners[..., 3, :] * du
    return top * (1.0 - dv) + bot * dv


def remap_image(img, remap):
    """Apply an undistortion remap grid.

    img: [H_in, W_in] raw image; remap: [H_out, W_out, 2] sample positions
    (-1 marks invalid). Returns [H_out, W_out] with invalid pixels = 0.
    An invalid position samples the clamped corner pixel (finite), which
    the mask then replaces.
    """
    out = bilinear(img, remap)
    return torch.where(remap[..., 0] >= 0, out, torch.zeros_like(out))
