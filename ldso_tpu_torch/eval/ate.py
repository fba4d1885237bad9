"""Trajectory evaluation: Umeyama alignment + ATE RMSE.

Copied from ``ldso_tpu/eval/ate.py`` (numpy; ``tests/test_torch_package.py``
pins the copy to the original), apart from the TUM writer's quaternion,
which comes from the port's ``math/lie``. Monocular trajectories are
aligned with a similarity transform (Sim(3) Umeyama, scale is
unobservable) before computing RMSE.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform: dst ≈ s·R·src + t.

    src, dst: [N, 3]. Returns (s, R [3,3], t [3])."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    with_scale: bool = True,
) -> Tuple[float, np.ndarray]:
    """Absolute trajectory error after Sim(3) (or SE(3)) alignment.

    est_positions, gt_positions: [N, 3] matched by index.
    Returns (rmse, per-frame residual norms)."""
    assert est_positions.shape == gt_positions.shape
    finite = np.isfinite(est_positions).all(axis=1) \
        & np.isfinite(gt_positions).all(axis=1)
    if not finite.all():            # degenerate poses (lost segments)
        est_positions = est_positions[finite]
        gt_positions = gt_positions[finite]
        if len(est_positions) < 3:
            return float("inf"), np.full(int(finite.sum()), np.inf)
    s, R, t = umeyama(est_positions, gt_positions, with_scale)
    aligned = (s * (R @ est_positions.T)).T + t
    err = np.linalg.norm(aligned - gt_positions, axis=1)
    return float(np.sqrt((err ** 2).mean())), err


def drift_per_distance(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    seg_fracs=(0.1, 0.25, 0.5),
) -> dict:
    """Relative drift as % of distance travelled, per segment length
    (the KITTI odometry t_rel metric's monocular analog; VERDICT r4 #7:
    ATE alone hides WHERE the error accumulates). The whole trajectory
    is Sim(3)-aligned ONCE (per-segment re-alignment is degenerate on
    short near-straight windows); for each segment length L the metric
    is the growth of the alignment residual across the segment,
    ‖err(end) − err(start)‖ / L, medianed over 12 windows.
    Returns {frac: median_drift_pct}."""
    s, R, t = umeyama(est_positions, gt_positions)
    aligned = (s * (R @ est_positions.T)).T + t
    err_vec = aligned - gt_positions
    gt_d = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(gt_positions, axis=0), axis=1))])
    total = gt_d[-1]
    out = {}
    for frac in seg_fracs:
        L = frac * total
        if L <= 0:
            out[frac] = float("nan")
            continue
        errs = []
        for s0 in np.linspace(0, total - L, 12):
            i0 = int(np.searchsorted(gt_d, s0))
            i1 = min(int(np.searchsorted(gt_d, s0 + L)),
                     len(gt_positions) - 1)
            if i1 - i0 < 3:
                continue
            errs.append(np.linalg.norm(err_vec[i1] - err_vec[i0]) / L)
        out[frac] = round(100.0 * float(np.median(errs)), 3) if errs \
            else float("nan")
    return out


def write_tum_trajectory(path: str, timestamps, poses_c_w: np.ndarray):
    """TUM format: ``timestamp tx ty tz qx qy qz qw`` of camera-to-world
    (inverted from the engine's world-to-camera), matching
    FullSystem::printResult output for downstream evo-style tooling."""
    import torch

    from ldso_tpu_torch.math import lie

    with open(path, "w") as f:
        for ts, Tcw in zip(timestamps, poses_c_w):
            Twc = np.linalg.inv(Tcw)
            q = lie.matrix_to_quat(torch.from_numpy(Twc[:3, :3].copy())).numpy()
            t = Twc[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def read_tum_trajectory(path: str):
    """Returns (timestamps [N], positions [N, 3], quats [N, 4] xyzw)."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            ts.append(vals[0])
            pos.append(vals[1:4])
            quat.append(vals[4:8])
    return np.asarray(ts), np.asarray(pos), np.asarray(quat)
