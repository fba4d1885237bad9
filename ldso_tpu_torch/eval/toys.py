"""Toy problem builders: ready-made windows for entry-point checks and
multi-rank dry runs.

Port of ``ldso_tpu/eval/toys.py``. It wraps the synthetic scene renderer
(``io/synthetic.py``) into the port's ``Window`` with ground truth
attached. The random draws (pose noise, then the point choice, then the
idepth noise) come from one ``np.random.default_rng(seed)`` in the
reference's order, so both packages pick the same points.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ldso_tpu_torch.config import LdsoConfig
from ldso_tpu_torch.core import window as W
from ldso_tpu_torch.io.synthetic import SyntheticDataset
from ldso_tpu_torch.kernels import interp, pyramid
from ldso_tpu_torch.math import lie


def make_synthetic_window(
    cfg: LdsoConfig,
    w: int = 256,
    h: int = 192,
    n_frames: int = 3,
    n_points: int | None = None,
    idepth_noise: float = 0.02,
    pose_noise: float = 0.002,
    seed: int = 0,
    *,
    device="cuda",
) -> Tuple[W.Window, SyntheticDataset]:
    """A BA-ready window on ``device``: n_frames keyframes along a
    synthetic trajectory, points hosted in frame 0 at textured pixels with
    (noisy) GT inverse depth. Capacities come from cfg.shapes (padding
    beyond n_points). Each frame's (I, dx, dy) stack is a one-level
    pyramid build (the CUDA kernel for a CUDA device)."""
    rng = np.random.default_rng(seed)
    n_points = n_points or cfg.shapes.max_points
    n_points = min(n_points, cfg.shapes.max_points)
    ds = SyntheticDataset(w=w, h=h, n=max(n_frames, 2), seed=seed)
    intr = ds.intrinsics()
    win = W.empty_window(cfg, h, w, intr, device)
    for i in range(n_frames):
        img, ts, exp = ds.get_image(i)
        # the renderer gives float64; the pyramid takes uint8 or float32
        pyr, _ = pyramid.build_pyramid(
            torch.as_tensor(np.asarray(img, np.float32), device=device), 1)
        T = ds.gt_pose_c_w(i)
        if pose_noise > 0 and i > 0:
            xi = torch.as_tensor(rng.normal(size=6) * pose_noise, device=device)
            T = lie.se3_exp(xi).cpu().numpy().astype(np.float64) @ T
        win = W.insert_frame(win, i, np.asarray(T, np.float32), pyr[0], exp)

    idep0 = ds.get_idepth(0)
    frame0 = win.images[0].cpu().numpy()
    img0, gx, gy = frame0[..., 0], frame0[..., 1], frame0[..., 2]
    gsq = gx ** 2 + gy ** 2
    ok = idep0 > 1e-3
    ok[:10, :] = ok[-10:, :] = False
    ok[:, :10] = ok[:, -10:] = False
    cand = np.argwhere(ok & (gsq > np.percentile(gsq, 60)))
    sel = cand[rng.choice(len(cand), size=n_points, replace=False)]
    uv = np.stack([sel[:, 1], sel[:, 0]], axis=-1).astype(np.float32)

    uvp = torch.as_tensor(uv[:, None, :] + W.PATTERN_OFFSETS[None], device=device)
    color = interp.bilinear(torch.as_tensor(img0, device=device), uvp)
    gsq_p = interp.bilinear(torch.as_tensor(gsq.astype(np.float32), device=device), uvp)
    c2 = cfg.ba.outlier_th_sum_component
    weight = torch.sqrt(c2 / (c2 + gsq_p))
    idep = idep0[sel[:, 0], sel[:, 1]]
    if idepth_noise > 0:
        idep = idep * (1.0 + rng.normal(size=idep.shape) * idepth_noise)
    win = W.add_points(win, np.arange(n_points), 0, uv, color, weight,
                       idep.astype(np.float32))
    return win, ds


def _np_lie(fn, v) -> np.ndarray:
    return fn(torch.as_tensor(np.asarray(v, np.float64))).numpy()


def sim3_circle_graph(K: int = 24, seed: int = 0):
    """The JAX package's 24-keyframe test circle (tests/test_distributed.py
    ``_toy_graph``): ground truth on a radius-2 circle turning about y,
    odometry chained with Sim(3) noise (σ 0.02 on the pose, 0.01 on log
    scale), exact odometry edges plus one loop edge (K-1, 0). Host float64:
    (gt, S, ei, ej, S_meas, w, fixed) with vertex 0 fixed."""
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(K) / K
    Twc = np.tile(np.eye(4), (K, 1, 1))
    Twc[:, :3, :3] = _np_lie(lie.so3_exp, np.stack([0 * th, th, 0 * th], -1))
    Twc[:, :3, 3] = np.stack([2 * np.sin(th), 0 * th, 2 * (1 - np.cos(th))], -1)
    gt = np.linalg.inv(Twc)
    tau = [np.concatenate([rng.normal(0, 0.02, 6), [rng.normal(0, 0.01)]])
           for _ in range(1, K)]
    return _chain_graph(gt, _np_lie(lie.sim3_exp, tau), [(K - 1, 0)], np.float64)


def sim3_curve_graph(K: int = 4096, n_loops: int = 40, seed: int = 0):
    """The JAX package's large test graph (tests/test_distributed.py
    ``_big_graph``): a smooth 3-D curve of K keyframes, odometry chained
    with Sim(3) noise (σ 0.002 on the pose, 0.001 on log scale), exact
    odometry edges and ``n_loops`` random loop edges reaching back at
    least K/8 keyframes. Float32: (gt, S, ei, ej, S_meas, w, fixed)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, K)
    Twc = np.tile(np.eye(4), (K, 1, 1))
    Twc[:, :3, :3] = _np_lie(lie.so3_exp, np.stack([0 * t, 0.3 * np.sin(t), 0 * t], -1))
    Twc[:, :3, 3] = np.stack([np.sin(t) * 5, 0.1 * t, t], -1)
    gt = np.linalg.inv(Twc).astype(np.float32)
    tau = [np.concatenate([rng.normal(0, 0.002, 6), [rng.normal(0, 0.001)]])
           for _ in range(1, K)]
    loops = []
    for _ in range(n_loops):
        a = int(rng.integers(K // 4, K))
        loops.append((a, int(rng.integers(0, a - K // 8))))
    return _chain_graph(gt, _np_lie(lie.sim3_exp, tau), loops, np.float32)


def _chain_graph(gt, noise, loops, dtype):
    """Odometry chained from gt[0] through ``noise`` [K-1] Sim(3) factors,
    exact odometry edges (i, i-1), then the ``loops`` edges."""
    K = len(gt)
    S = [gt[0]]
    for i in range(1, K):
        S.append(noise[i - 1] @ (gt[i] @ np.linalg.inv(gt[i - 1])) @ S[-1])
    pairs = [(i, i - 1) for i in range(1, K)] + list(loops)
    ei = np.asarray([a for a, _ in pairs], np.int32)
    ej = np.asarray([b for _, b in pairs], np.int32)
    S_meas = np.stack([gt[a] @ np.linalg.inv(gt[b]) for a, b in pairs]).astype(dtype)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (gt, np.stack(S).astype(dtype), ei, ej, S_meas, np.ones(len(pairs), dtype),
            fixed)


def sim3_centers(S: np.ndarray) -> np.ndarray:
    """[K, 4, 4] Sim(3) worldToCam -> [K, 3] camera centres, scale removed."""
    R = S[:, :3, :3]
    sc = np.linalg.norm(R[:, 0, :], axis=-1)[:, None, None]
    return -np.einsum("kji,kj->ki", R / sc, S[:, :3, 3] / sc[:, :, 0])
