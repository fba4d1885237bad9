"""Camera model: ideal pinhole projection helpers and the calibration record.

Port of the pinhole part of ``ldso_tpu/cameras.py``. Undistortion (the
remap grids of the FOV / RadTan / equidistant models and the
``camera.txt`` parser) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def project(X, intr):
    """[..., 3] camera-frame points + intr [..., 4] (fx fy cx cy) -> [..., 2] pixels."""
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    z = X[..., 2]
    return torch.stack([fx * X[..., 0] / z + cx, fy * X[..., 1] / z + cy], dim=-1)


def backproject(uv, idepth, intr):
    """Pixels [..., 2] + inverse depth [...] -> camera-frame points [..., 3]."""
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    d = 1.0 / idepth
    return torch.stack([x * d, y * d, d], dim=-1)


def level_intrinsics(intr, level):
    """Intrinsics at pyramid level l: fx_l = fx·2^-l, cx_l = (cx+0.5)·2^-l − 0.5."""
    s = 0.5 ** level
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    return torch.stack([fx * s, fy * s, (cx + 0.5) * s - 0.5, (cy + 0.5) * s - 0.5],
                       dim=-1)


@dataclasses.dataclass(frozen=True)
class CameraCalib:
    """Full geometric calibration: raw camera -> ideal pinhole output."""

    model: str
    in_size: Tuple[int, int]         # (w, h) of raw images
    in_intr: Tuple[float, ...]       # fx fy cx cy of the RAW camera
    dist_params: Tuple[float, ...]   # model-specific distortion coefficients
    out_size: Tuple[int, int]        # (w, h) of undistorted output
    out_intr: Tuple[float, float, float, float]  # ideal pinhole fx fy cx cy


def pinhole_calib(w: int, h: int, fx: float, fy: float, cx: float, cy: float) -> CameraCalib:
    """Identity calibration (already-rectified input, e.g. KITTI / synthetic)."""
    return CameraCalib("pinhole", (w, h), (fx, fy, cx, cy), (), (w, h), (fx, fy, cx, cy))
