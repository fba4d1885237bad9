"""Offline visualization dumps (the headless analog of the reference's
Pangolin viewer, reference: n-lalanne/LDSO src/frontend/DSOViewer.cc —
trajectory + colored point cloud + per-KF depth overlays).

Port of ``ldso_tpu/viz.py`` (numpy and files; the window is read back
from the device once per dump). Instead of a live GL window this writes
artifacts to a directory:
  * ``trajectory.png``  — top-down + side view of the camera path
    (matplotlib when available, pure-PPM fallback otherwise)
  * ``map.ply``         — world point cloud with intensity colors
    (text PLY, loadable in MeshLab/CloudCompare/rerun)
  * ``depth_kf<k>.png/.ppm`` — inverse-depth overlays of window KFs
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _centers(poses_cw: np.ndarray) -> np.ndarray:
    return np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in poses_cw])


def write_ply(path: str, xyz: np.ndarray, intensity: Optional[np.ndarray] = None):
    """Text PLY point cloud; intensity (0..255) mapped to gray RGB."""
    n = len(xyz)
    inten = np.full(n, 200.0) if intensity is None else np.clip(intensity, 0, 255)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(xyz, inten):
            ci = int(c)
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {ci} {ci} {ci}\n")


def _save_gray_image(path: str, img: np.ndarray):
    """Save [H, W] float 0..255 as PNG (matplotlib) or PPM fallback."""
    img8 = np.clip(img, 0, 255).astype(np.uint8)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(path, img8, cmap="gray", vmin=0, vmax=255)
    except ImportError:
        path = os.path.splitext(path)[0] + ".ppm"
        with open(path, "wb") as f:
            h, w = img8.shape
            f.write(f"P5\n{w} {h}\n255\n".encode())
            f.write(img8.tobytes())


def dump_trajectory(out_dir: str, poses_cw: np.ndarray,
                    gt_cw: Optional[np.ndarray] = None):
    """Top-down (x-z) and side (z-y) path plots."""
    os.makedirs(out_dir, exist_ok=True)
    c = _centers(poses_cw)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(11, 5))
        axes[0].plot(c[:, 0], c[:, 2], "b-", lw=1, label="estimate")
        axes[1].plot(c[:, 2], -c[:, 1], "b-", lw=1)
        if gt_cw is not None:
            g = _centers(gt_cw)
            axes[0].plot(g[:, 0], g[:, 2], "k--", lw=1, label="ground truth")
            axes[1].plot(g[:, 2], -g[:, 1], "k--", lw=1)
        axes[0].set_xlabel("x [m]"); axes[0].set_ylabel("z [m]")
        axes[0].set_title("top-down"); axes[0].axis("equal"); axes[0].legend()
        axes[1].set_xlabel("z [m]"); axes[1].set_ylabel("height [m]")
        axes[1].set_title("side"); axes[1].axis("equal")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "trajectory.png"), dpi=120)
        plt.close(fig)
    except ImportError:
        np.savetxt(os.path.join(out_dir, "trajectory_xyz.txt"), c)


def dump_map(out_dir: str, system) -> int:
    """Full-map world point cloud — persistent archived points of every
    marginalized KF (pose-graph corrected) plus the live window
    (reference: Map.cc's global point store + the active window) — and
    per-KF inverse-depth overlays."""
    os.makedirs(out_dir, exist_ok=True)
    Xw, color = system.global_map_points(include_window=True)
    if len(Xw) == 0:
        return 0
    write_ply(os.path.join(out_dir, "map.ply"), Xw, color)

    # per-KF sparse inverse-depth overlays (live window only)
    win = system.win
    p_valid = win.p_valid.cpu().numpy()
    p_host = win.p_host.cpu().numpy()
    uv = win.p_uv.cpu().numpy()
    idep = np.maximum(win.p_idepth.cpu().numpy(), 1e-6)
    idx = np.flatnonzero(p_valid)
    imgs = win.images[..., 0].cpu().numpy()
    for slot, kid in enumerate(system.slot_kf):
        if kid is None:
            continue
        sel = idx[p_host[idx] == slot]
        img = imgs[slot].copy() * 0.6
        for p in sel:
            u, v = int(uv[p, 0]), int(uv[p, 1])
            val = 255.0 * min(idep[p] / 2.0, 1.0)
            img[max(v - 1, 0): v + 2, max(u - 1, 0): u + 2] = val
        _save_gray_image(os.path.join(out_dir, f"depth_kf{kid}.png"), img)
    return len(Xw)
