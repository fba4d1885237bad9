#!/usr/bin/env python3
"""Write a synthetic sequence to disk in the TUM-monoVO layout.

    python3 scripts/torch_tum_fixture.py OUT_DIR [--frames 120] [--width 640]
        [--height 480] [--omega 0.5] [--seed 3]

The layout is the one ``ldso_tpu_torch.io.datasets.TumMonoDataset`` reads:
``images.zip`` (8-bit grayscale PNGs), ``times.txt`` (id, timestamp,
exposure), ``camera.txt`` (an FOV lens, ``crop`` mode), ``pcalib.txt`` (the
inverse response G⁻¹) and ``vignette.png``. The frames are the port's
synthetic corridor sequence (forward_arc) rendered larger than the output,
warped through a real FOV (ATAN) lens of parameter omega, multiplied by a
per-frame exposure and a radial vignette, and sent through a γ = 2.2
camera response: the recipe of the JAX package's
``tests/test_datasets_e2e.py::make_tum_fixture``, with the ground-truth
poses returned beside the directory. Needs numpy, scipy and zlib only.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import zipfile
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GAMMA = 2.2


def encode_png_gray(img: np.ndarray) -> bytes:
    """Minimal 8-bit grayscale PNG writer (filter 0 rows)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def g_inv(p):
    """Inverse response G⁻¹: pixel value -> irradiance (pcalib.txt)."""
    return 255.0 * (np.asarray(p, np.float64) / 255.0) ** GAMMA


def g(i):
    """Camera response G: irradiance -> pixel value."""
    return 255.0 * np.clip(np.asarray(i, np.float64) / 255.0, 0, 1) ** (1 / GAMMA)


def radial_vignette(w, h, floor=0.72):
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    r = np.hypot(u - w / 2 + 0.5, v - h / 2 + 0.5)
    return 1.0 - (1.0 - floor) * (r / r.max()) ** 2


def fov_distorted_view(render, f, cx_r, cy_r, w, h, omega):
    """The RAW (FOV-distorted) image a real ATAN-lens camera with
    intrinsics (f, f, w/2-.5, h/2-.5) would capture of the clean pinhole
    render. Closed-form FOV undistort per raw pixel:
    r_u = tan(r_d·ω) / (2·tan(ω/2))."""
    from scipy.ndimage import map_coordinates

    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    ud, vd = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    xd, yd = (ud - cx) / f, (vd - cy) / f
    r_d = np.hypot(xd, yd)
    r_u = np.tan(r_d * omega) / (2.0 * np.tan(omega / 2.0))
    s = np.where(r_d < 1e-9, 1.0, r_u / np.maximum(r_d, 1e-12))
    su = f * xd * s + cx_r
    sv = f * yd * s + cy_r
    return map_coordinates(render, [sv, su], order=1, mode="nearest")


def _renderer(n, w, h, seed):
    """The clean pinhole renderer, LARGER than the output so that the
    undistortion's wider field stays inside valid pixels (no border clamp
    junk in the raw images); returns (renderer, focal length)."""
    from ldso_tpu_torch.io.synthetic import SyntheticDataset

    f = 0.88 * w
    return SyntheticDataset(w=w + w // 4, h=h + h // 4, n=n, fov_focal=f, seed=seed,
                            scene_kind="corridor", traj_kind="forward_arc",
                            supersample=1, cache=False), f


def render_pngs(n, w, h, omega, with_distortion, seed, lo, hi) -> list:
    """The PNG bytes of frames lo..hi-1 of the n-frame fixture."""
    ds, f = _renderer(n, w, h, seed)
    wr, hr = ds.w, ds.h
    vig = radial_vignette(w, h)
    expo = 1.0 + 0.1 * np.sin(0.4 * np.arange(n))
    pngs = []
    for i in range(lo, hi):
        render = np.asarray(ds.get_image(i)[0], np.float64)
        if with_distortion:
            raw_irr = fov_distorted_view(render, f, wr / 2 - 0.5, hr / 2 - 0.5, w, h, omega)
        else:
            y0, x0 = (hr - h) // 2, (wr - w) // 2
            raw_irr = render[y0:y0 + h, x0:x0 + w]
        px = np.clip(np.round(g(raw_irr * expo[i] * vig)), 0, 255)
        pngs.append(encode_png_gray(px.astype(np.uint8)))
    return pngs


def make_tum_fixture(root, n=45, w=320, h=240, omega=0.5,
                     with_distortion=True, seed=3, pool=None):
    """Synthetic TUM-monoVO dataset on disk; returns (dir, ds_gt), where
    ``ds_gt`` is the renderer with the ground-truth poses
    (``poses_w_c``, ``gt_pose_c_w(i)``; frame i has timestamp i·0.05).
    With an executor ``pool``, chunks of 15 frames are rendered on its
    workers."""
    os.makedirs(root, exist_ok=True)
    ds, f = _renderer(n, w, h, seed)
    vig = radial_vignette(w, h)
    expo = 1.0 + 0.1 * np.sin(0.4 * np.arange(n))
    args = (n, w, h, omega, with_distortion, seed)
    if pool is None:
        pngs = render_pngs(*args, 0, n)
    else:
        parts = [pool.submit(render_pngs, *args, lo, min(lo + 15, n))
                 for lo in range(0, n, 15)]
        pngs = [png for p in parts for png in p.result()]

    rows = []
    with zipfile.ZipFile(os.path.join(root, "images.zip"), "w",
                         zipfile.ZIP_STORED) as zf:
        for i, png in enumerate(pngs):
            zf.writestr(f"{i:05d}.png", png)
            rows.append(f"{i:05d} {i * 0.05:.6f} {expo[i]:.6f}")

    with open(os.path.join(root, "times.txt"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "camera.txt"), "w") as fh:
        if with_distortion:
            fh.write(f"0.88 {f / h:.8f} 0.5 0.5 {omega}\n")
        else:
            fh.write(f"0.88 {f / h:.8f} 0.5 0.5\n")
        fh.write(f"{w} {h}\ncrop\n{w} {h}\n")
    with open(os.path.join(root, "pcalib.txt"), "w") as fh:
        fh.write(" ".join(f"{v:.6f}" for v in g_inv(np.arange(256))) + "\n")
    with open(os.path.join(root, "vignette.png"), "wb") as fh:
        fh.write(encode_png_gray(np.round(vig * 255).astype(np.uint8)))
    return root, ds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--omega", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=3)
    a = p.parse_args(argv)
    root, _ = make_tum_fixture(a.out_dir, n=a.frames, w=a.width, h=a.height,
                               omega=a.omega, seed=a.seed)
    print(f"wrote {a.frames} frames {a.width}x{a.height} -> {root}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
