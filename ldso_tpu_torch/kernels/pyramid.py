"""Image pyramid + gradient construction.

Port of ``ldso_tpu/kernels/pyramid.py``: per pyramid level an (I, dx, dy)
stack and the squared gradient magnitude used by pixel selection. Levels
are built by 2x2 averaging, gradients by central differences with
clamped borders.

``build_pyramid`` takes the plain torch version for a CPU tensor and
launches the CUDA kernel (``kernels/pallas_pyramid.py``) for a CUDA
tensor; there is no fallback between the two.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def level_shapes(w: int, h: int, levels: int) -> List[Tuple[int, int]]:
    """Per-level (w, h); requires divisibility so all levels are exact."""
    shapes = []
    for l in range(levels):
        if w % (1 << l) or h % (1 << l):
            raise ValueError(f"image {w}x{h} not divisible at level {l}; crop "
                             f"to a multiple of {1 << (levels - 1)}")
        shapes.append((w >> l, h >> l))
    return shapes


def crop_to_multiple(img, levels: int):
    """Crop bottom/right so both dims divide by 2^(levels-1)."""
    m = 1 << (levels - 1)
    h, w = img.shape[-2], img.shape[-1]
    return img[..., : (h // m) * m, : (w // m) * m]


def _downsample2(img):
    """2x2 average pooling, [..., H, W] -> [..., H/2, W/2]."""
    h, w = img.shape[-2:]
    return img.reshape(*img.shape[:-2], h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def _gradients(img):
    """Central differences with clamped borders: [..., H, W] -> dx, dy."""
    right = torch.cat([img[..., 1:], img[..., -1:]], dim=-1)
    left = torch.cat([img[..., :1], img[..., :-1]], dim=-1)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    up = torch.cat([img[..., :1, :], img[..., :-1, :]], dim=-2)
    return 0.5 * (right - left), 0.5 * (down - up)


def build_pyramid_torch(img, levels: int):
    """Plain torch pyramid of one frame [H, W] or a batch [B, H, W] (per
    frame equal to the reference's ``build_pyramid_xla``)."""
    pyr, gsq = [], []
    cur = img.to(torch.float32)              # uint8 frames widen here
    for l in range(levels):
        dx, dy = _gradients(cur)
        pyr.append(torch.stack([cur, dx, dy], dim=-1))
        gsq.append(dx * dx + dy * dy)
        if l + 1 < levels:
            cur = _downsample2(cur)
    return pyr, gsq


def build_pyramid(img, levels: int):
    """img [H, W] or [B, H, W] uint8/f32 -> (pyramid, grad_sq):
      pyramid: list of [(B,) H_l, W_l, 3] (I, dx, dy) stacks, finest first
      grad_sq: list of [(B,) H_l, W_l] squared gradient magnitude
    A CUDA tensor goes through the kernel, in one launch for the batch.
    """
    if img.device.type == "cpu":
        return build_pyramid_torch(img, levels)
    if img.device.type == "cuda":
        from ldso_tpu_torch.kernels.pallas_pyramid import build_pyramid_cuda

        return build_pyramid_cuda(img.contiguous(), levels)
    raise ValueError(f"no pyramid build for device {img.device}")
