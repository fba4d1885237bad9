"""Camera models: pinhole projection + geometric undistortion.

Port of ``ldso_tpu/cameras.py``. The pinhole helpers run on torch tensors
on the device. Each lens model is a pure distortion function on normalized
coordinates; the remap grid is computed once on the host in float64
(numpy, copied from the reference and held equal to it by
``tests/test_torch_cameras.py``), and the per-frame remap is a bilinear
gather on the device (``kernels/interp.remap_image``).

Supported models (reference: Undistort{Pinhole,FOV,RadTan,Equidistant,KB}):
  * ``pinhole``      — fx fy cx cy
  * ``fov``/``atan`` — fx fy cx cy omega            (ATAN / FOV model)
  * ``radtan``       — fx fy cx cy k1 k2 r1 r2     (OpenCV plumb-bob)
  * ``equidistant``  — fx fy cx cy k1 k2 k3 k4
  * ``kb``           — fx fy cx cy k1 k2 k3 k4     (Kannala-Brandt ≡ equidistant poly)

After undistortion everything downstream is an ideal pinhole with 4
intrinsics (the BA's CPARS=4 state).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
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


def intr_matrix(intr):
    """[..., 4] -> [..., 3, 3] K."""
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([fx, z, cx], dim=-1),
            torch.stack([z, fy, cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def level_intrinsics(intr, level):
    """Intrinsics at pyramid level l: fx_l = fx·2^-l, cx_l = (cx+0.5)·2^-l − 0.5."""
    s = 0.5 ** level
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    return torch.stack([fx * s, fy * s, (cx + 0.5) * s - 0.5, (cy + 0.5) * s - 0.5],
                       dim=-1)


# ---------------------------------------------------------------------------
# Distortion models (normalized coords -> distorted normalized coords)
# ---------------------------------------------------------------------------


def _distort_fov(x, y, params):
    (omega,) = params
    r = np.sqrt(x * x + y * y)
    fac = np.where(
        r < 1e-8,
        omega / (2.0 * np.tan(omega / 2.0)),
        np.arctan(2.0 * r * np.tan(omega / 2.0)) / np.maximum(omega * r, 1e-12),
    )
    return x * fac, y * fac


def _distort_radtan(x, y, params):
    k1, k2, r1, r2 = params
    r2_ = x * x + y * y
    radial = 1.0 + k1 * r2_ + k2 * r2_ * r2_
    xd = x * radial + 2.0 * r1 * x * y + r2 * (r2_ + 2.0 * x * x)
    yd = y * radial + 2.0 * r2 * x * y + r1 * (r2_ + 2.0 * y * y)
    return xd, yd


def _distort_equidistant(x, y, params):
    k1, k2, k3, k4 = params
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3 + k4 * t2 ** 4)
    scale = np.where(r < 1e-8, 1.0, theta_d / np.maximum(r, 1e-12))
    return x * scale, y * scale


_DISTORT = {
    "pinhole": lambda x, y, p: (x, y),
    "fov": _distort_fov,
    "atan": _distort_fov,
    "radtan": _distort_radtan,
    "equidistant": _distort_equidistant,
    "kb": _distort_equidistant,
}


@dataclasses.dataclass(frozen=True)
class CameraCalib:
    """Full geometric calibration: raw camera -> ideal pinhole output."""

    model: str                       # key into _DISTORT
    in_size: Tuple[int, int]         # (w, h) of raw images
    in_intr: Tuple[float, ...]       # fx fy cx cy of the RAW camera
    dist_params: Tuple[float, ...]   # model-specific distortion coefficients
    out_size: Tuple[int, int]        # (w, h) of undistorted output
    out_intr: Tuple[float, float, float, float]  # ideal pinhole fx fy cx cy

    @property
    def out_intr_array(self) -> np.ndarray:
        return np.asarray(self.out_intr, dtype=np.float32)


def _relative_to_absolute(intr, w, h):
    """The reference's calib files store fx/fy/cx/cy relative to image size
    when values are < 1 (Undistort.cc: ``if cx < 1 && cy < 1``)."""
    fx, fy, cx, cy = intr
    if cx < 1.0 and cy < 1.0:
        return (fx * w, fy * h, cx * w - 0.5, cy * h - 0.5)
    return intr


def make_remap(calib: CameraCalib) -> np.ndarray:
    """Precompute the undistortion remap grid.

    Returns [H_out, W_out, 2] float32: for each output (ideal pinhole)
    pixel, the (u, v) sample position in the raw input image, or -1 where
    the sample falls outside the input (reference: Undistort::distortCoordinates
    + remap validity handling).
    """
    w_out, h_out = calib.out_size
    fx_o, fy_o, cx_o, cy_o = calib.out_intr
    fx_i, fy_i, cx_i, cy_i = calib.in_intr

    u, v = np.meshgrid(np.arange(w_out, dtype=np.float64), np.arange(h_out, dtype=np.float64))
    # ideal normalized coords
    x = (u - cx_o) / fx_o
    y = (v - cy_o) / fy_o
    xd, yd = _DISTORT[calib.model](x, y, calib.dist_params)
    ui = fx_i * xd + cx_i
    vi = fy_i * yd + cy_i

    w_in, h_in = calib.in_size
    valid = (ui >= 0) & (ui <= w_in - 1.001) & (vi >= 0) & (vi <= h_in - 1.001)
    remap = np.stack([np.where(valid, ui, -1.0), np.where(valid, vi, -1.0)], axis=-1)
    return remap.astype(np.float32)


def find_crop_intrinsics(
    model: str,
    in_size: Tuple[int, int],
    in_intr: Tuple[float, ...],
    dist_params: Tuple[float, ...],
    out_size: Tuple[int, int],
) -> Tuple[float, float, float, float]:
    """Compute output pinhole intrinsics in "crop" mode: the tightest view
    such that every output pixel samples inside the raw image (behavioral
    analog of Undistort::makeOptimalK_crop, reference Undistort.cc).

    Strategy: binary-search a zoom factor around the distortion-centered
    view; per trial, test the output border pixels for in-bounds sampling.
    """
    w_out, h_out = out_size
    w_in, h_in = in_size
    fx_i, fy_i, cx_i, cy_i = in_intr[0], in_intr[1], in_intr[2], in_intr[3]

    # border sample of output pixels in normalized units for trial focal f
    tb = np.linspace(0, w_out - 1, 100)
    lr = np.linspace(0, h_out - 1, 100)
    border_u = np.concatenate([tb, tb, np.zeros_like(lr), np.full_like(lr, w_out - 1)])
    border_v = np.concatenate([np.zeros_like(tb), np.full_like(tb, h_out - 1), lr, lr])

    cx_o, cy_o = (w_out - 1) / 2.0, (h_out - 1) / 2.0

    def all_inside(f):
        x = (border_u - cx_o) / f
        y = (border_v - cy_o) / f  # isotropic focal
        xd, yd = _DISTORT[model](x, y, dist_params)
        ui = fx_i * xd + cx_i
        vi = fy_i * yd + cy_i
        return bool(np.all((ui >= 0) & (ui <= w_in - 1.001) & (vi >= 0) & (vi <= h_in - 1.001)))

    lo, hi = 1.0, 20.0 * max(fx_i, fy_i)
    # grow lo until inside or give up; binary search the transition
    if not all_inside(hi):
        raise ValueError("crop-mode search failed: no focal keeps the border inside")
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if all_inside(mid):
            hi = mid
        else:
            lo = mid
    f = hi * 1.001
    return (f, f, cx_o, cy_o)


def parse_calib_text(text: str, out_size: Optional[Tuple[int, int]] = None) -> CameraCalib:
    """Parse the reference's ``camera.txt`` format (Undistort::getUndistorterForFile):

        line 1: [model] fx fy cx cy [dist...]   (model omitted => 5-param = FOV/ATAN,
                                                 4-param = Pinhole, 8-param = RadTan)
        line 2: in_w in_h
        line 3: crop | full | fx fy cx cy 0
        line 4: out_w out_h
    """
    lines = [ln.strip() for ln in text.strip().splitlines() if ln.strip()]
    toks = lines[0].split()
    named = {"pinhole", "fov", "atan", "radtan", "equidistant", "kb"}
    if toks[0].lower() in named:
        model = toks[0].lower()
        vals = [float(t) for t in toks[1:]]
    else:
        vals = [float(t) for t in toks]
        if len(vals) == 4:
            model = "pinhole"
        elif len(vals) == 5:
            model = "fov"
        elif len(vals) == 8:
            model = "radtan"
        else:
            raise ValueError(f"cannot infer camera model from {len(vals)} params")
    in_w, in_h = (int(float(t)) for t in lines[1].split())
    intr = _relative_to_absolute(tuple(vals[:4]), in_w, in_h)
    dist = tuple(vals[4:])

    if out_size is None:
        out_w, out_h = (int(float(t)) for t in lines[3].split())
    else:
        out_w, out_h = out_size

    mode_toks = lines[2].split()
    if mode_toks[0] == "crop":
        out_intr = find_crop_intrinsics(model, (in_w, in_h), intr, dist, (out_w, out_h))
    elif mode_toks[0] == "full" or mode_toks[0] == "none":
        sx, sy = out_w / in_w, out_h / in_h
        out_intr = (intr[0] * sx, intr[1] * sy, (intr[2] + 0.5) * sx - 0.5, (intr[3] + 0.5) * sy - 0.5)
    else:
        o = _relative_to_absolute(tuple(float(t) for t in mode_toks[:4]), out_w, out_h)
        out_intr = o
    return CameraCalib(model, (in_w, in_h), intr, dist, (out_w, out_h), out_intr)


def pinhole_calib(w: int, h: int, fx: float, fy: float, cx: float, cy: float) -> CameraCalib:
    """Identity calibration (already-rectified input, e.g. KITTI / synthetic)."""
    return CameraCalib("pinhole", (w, h), (fx, fy, cx, cy), (), (w, h), (fx, fy, cx, cy))
