"""Trajectory evaluation: Umeyama alignment + ATE RMSE.

Copied from ``ldso_tpu/eval/ate.py`` (numpy only; ``tests/test_torch_package.py``
pins the copy to the original). Monocular trajectories are aligned with a
similarity transform (Sim(3) Umeyama, scale is unobservable) before
computing RMSE.
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

