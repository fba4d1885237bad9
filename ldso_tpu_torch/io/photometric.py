"""Photometric calibration: camera response inverse + vignette.

Port of ``ldso_tpu/io/photometric.py`` (the reference's
``PhotometricUndistorter``): a 256-entry inverse-response LUT ``G⁻¹``
(from ``pcalib.txt``) maps raw 8-bit pixel values to irradiance, which is
then divided by a vignette attenuation map (``vignette.png``, 16-bit). The
output image is in (relative) irradiance units; exposure time rides along
separately and enters the affine brightness model in the tracker/BA.

The calibration container and the ``pcalib.txt`` parser are numpy, copied
from the reference; the application is a gather and a multiply on the
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PhotometricCalib:
    """Host-side container; arrays are device-ready constants."""

    inv_response: Optional[np.ndarray] = None   # [256] f32, G⁻¹ LUT (None = identity)
    vignette_inv: Optional[np.ndarray] = None   # [H, W] f32, 1/V (None = 1)

    @staticmethod
    def identity() -> "PhotometricCalib":
        return PhotometricCalib()

    @staticmethod
    def from_arrays(response_lut: Optional[np.ndarray], vignette: Optional[np.ndarray]) -> "PhotometricCalib":
        """response_lut: G⁻¹ as 256 floats (pcalib.txt values, any scale —
        normalized to [0, 255] like the reference); vignette: [H, W] map
        (max-normalized like the reference)."""
        inv = None
        if response_lut is not None:
            lut = np.asarray(response_lut, dtype=np.float64)
            if lut.shape[0] != 256:
                # reference supports only 256-entry LUTs; resample if needed
                xs = np.linspace(0, 1, lut.shape[0])
                lut = np.interp(np.linspace(0, 1, 256), xs, lut)
            lut = lut - lut.min()
            lut = lut / lut.max() * 255.0
            inv = lut.astype(np.float32)
        vin = None
        if vignette is not None:
            v = np.asarray(vignette, dtype=np.float64)
            v = v / v.max()
            vin = (1.0 / np.maximum(v, 1e-3)).astype(np.float32)
        return PhotometricCalib(inv, vin)


def parse_pcalib_text(text: str) -> np.ndarray:
    """Parse pcalib.txt: whitespace-separated G values (reference:
    PhotometricUndistorter ctor)."""
    return np.asarray([float(t) for t in text.split()], dtype=np.float32)


def apply_photometric(raw_u8, inv_response, vignette_inv):
    """raw_u8 [H, W] (uint8 or float in [0,255]) -> irradiance f32 [H, W].

    Tensors on one device. Either calibration input may be None
    (identity)."""
    if raw_u8.dtype == torch.uint8:
        # an index tensor must be int64: a uint8 one is read as a mask
        idx = raw_u8.long()
        img = inv_response[idx] if inv_response is not None else idx.to(torch.float32)
    else:
        img = raw_u8.to(torch.float32)
        if inv_response is not None:
            # fractional LUT lookup for float inputs
            i0 = torch.clamp(torch.floor(img), 0, 254).long()
            frac = img - i0.to(torch.float32)
            img = inv_response[i0] * (1.0 - frac) + inv_response[i0 + 1] * frac
    if vignette_inv is not None:
        img = img * vignette_inv
    return img


def make_photometric_fn(calib: PhotometricCalib, device):
    """Build an undistorter closure for this calibration; the LUT and the
    vignette are put on ``device`` once."""
    inv = None if calib.inv_response is None \
        else torch.as_tensor(calib.inv_response, device=device)
    vig = None if calib.vignette_inv is None \
        else torch.as_tensor(calib.vignette_inv, device=device)
    return lambda raw: apply_photometric(raw, inv, vig)
