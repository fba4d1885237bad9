"""Monocular bootstrap: two-frame coarse initialization.

Port of ``ldso_tpu/init2f.py``: joint coarse-to-fine Gauss-Newton over
the relative pose + affine (8 dof) and all per-point inverse depths, with
the α-prior that pulls inverse depths to 1 and translation to 0 until
parallax "snaps", then a neighbour-coupling prior toward a smoothed depth
field ``iR`` (regularized to the neighbour median between iterations).
The k-NN graph comes from scipy's cKDTree on the host, once. A level's
iterations run in one launch of the CUDA kernel ``csrc/init_level.cu``
(K6, ``kernels/init_level.py``) for CUDA tensors, in the plain version
``init_level_torch`` for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ldso_tpu_torch import select
from ldso_tpu_torch.cameras import level_intrinsics
from ldso_tpu_torch.config import LdsoConfig
from ldso_tpu_torch.core.window import pattern
from ldso_tpu_torch.kernels.interp import bilinear, bilinear33, in_bounds
from ldso_tpu_torch.math import lie


class InitLevelOut(NamedTuple):
    T: torch.Tensor
    ab: torch.Tensor
    idepth: torch.Tensor
    iR: torch.Tensor
    good: torch.Tensor
    energy: torch.Tensor
    t_norm_sq: torch.Tensor
    n_good: torch.Tensor


def _median_midpoint(x):
    """``jnp.median`` along the last axis (method "midpoint": the mean of
    the two middle values for an even count; torch.median takes the lower)."""
    n = x.shape[-1]
    xs = torch.sort(x, dim=-1).values
    return (xs[..., (n - 1) // 2] + xs[..., n // 2]) * 0.5


def init_level(img3_new, uv, colors, neighbors, T0, ab0, idepth0, iR0, good0,
               intr0, level: int, iters: int, snapped: bool,
               alpha_w: float = 150.0 * 150.0, alpha_k: float = 2.5e5,
               coupling: float = 1.0, reg_weight: float = 0.8,
               huber_th: float = 9.0) -> InitLevelOut:
    """GN iterations at one pyramid level: ``init_level_torch`` for CPU
    tensors, the CUDA kernel (``kernels/init_level``, one launch a level)
    for CUDA tensors."""
    args = (img3_new, uv, colors, neighbors, T0, ab0, idepth0, iR0, good0, intr0)
    kw = dict(level=level, iters=iters, snapped=snapped, alpha_w=alpha_w, alpha_k=alpha_k,
              coupling=coupling, reg_weight=reg_weight, huber_th=huber_th)
    if uv.device.type == "cpu":
        return init_level_torch(*args, **kw)
    if uv.device.type == "cuda":
        from ldso_tpu_torch.kernels.init_level import init_level_cuda

        return InitLevelOut(*init_level_cuda(*(a.contiguous() for a in args), **kw)[:8])
    raise ValueError(f"no bootstrap level for device {uv.device}")


def init_level_torch(img3_new, uv, colors, neighbors, T0, ab0, idepth0, iR0, good0,
                     intr0, level: int, iters: int, snapped: bool,
                     alpha_w: float = 150.0 * 150.0, alpha_k: float = 2.5e5,
                     coupling: float = 1.0, reg_weight: float = 0.8,
                     huber_th: float = 9.0, ladder: Optional[list] = None) -> InitLevelOut:
    """GN iterations at one pyramid level (reference: trackFrame's loop
    over calcResAndGS / doStep / optReg), the plain torch version of the
    kernel. One system evaluation per iteration: the current state's
    system is carried. With a list ``ladder``, (E, the trial's E') of each
    iteration is appended to it (0-dim tensors)."""
    h, w = img3_new.shape[0], img3_new.shape[1]
    dev = uv.device
    s = 0.5 ** level
    uv_l = uv * s + (0.5 * s - 0.5)
    intr_l = level_intrinsics(intr0, level)
    fx, fy, cx, cy = intr_l[0], intr_l[1], intr_l[2], intr_l[3]
    uvp = uv_l[:, None, :] + pattern(dev)[None]                        # [N, 8, 2]
    xh = torch.stack([(uvp[..., 0] - cx) / fx, (uvp[..., 1] - cy) / fy,
                      torch.ones_like(uvp[..., 0])], dim=-1)
    nbr = neighbors.long()
    eye8 = torch.eye(8, dtype=T0.dtype, device=dev)

    def system(T, ab, d, iR, good):
        R, t = T[:3, :3], T[:3, 3]
        X = xh @ R.T + t * d[:, None, None]
        z = X[..., 2]
        okz = z > 1e-6
        zs = torch.where(okz, z, torch.ones_like(z))
        up, vp = X[..., 0] / zs, X[..., 1] / zs
        uvn = torch.stack([fx * up + cx, fy * vp + cy], dim=-1)
        inb = in_bounds(uvn, w, h, 2.0) & okz
        hit = bilinear33(img3_new, uvn)
        r = hit[..., 0] - torch.exp(ab[0]) * colors - ab[1]
        abs_r = torch.abs(r)
        hw = torch.where(abs_r < huber_th, 1.0, huber_th / torch.clamp(abs_r, min=1e-12))
        om = torch.where(inb & good[:, None], hw, 0.0)

        pt_ok = torch.sum(inb, dim=-1) >= 6
        e_pt = torch.sum(torch.where(inb, hw * r * r * (2.0 - hw), 0.0), dim=-1)

        g = hit[..., 1:3]
        new_id = d[:, None] / zs
        zeros = torch.zeros_like(up)
        Jp_u = torch.stack([new_id * fx, zeros, -new_id * up * fx,
                            -up * vp * fx, (1 + up * up) * fx, -vp * fx], dim=-1)
        Jp_v = torch.stack([zeros, new_id * fy, -new_id * vp * fy,
                            -(1 + vp * vp) * fy, up * vp * fy, up * fy], dim=-1)
        J_pose = g[..., 0:1] * Jp_u + g[..., 1:2] * Jp_v               # [N, 8, 6]
        J_a = (-torch.exp(ab[0]) * colors)[..., None]
        J_b = -torch.ones_like(colors)[..., None]
        Jx = torch.cat([J_pose, J_a, J_b], dim=-1)                     # [N, 8, 8]
        dre = 1.0 / zs
        Jd = (g[..., 0] * (fx * dre * (t[0] - t[2] * up))
              + g[..., 1] * (fy * dre * (t[1] - t[2] * vp)))           # [N, 8]

        Jxw = Jx * om[..., None]
        H = torch.einsum("pki,pkj->ij", Jxw, Jx)
        b = torch.einsum("pki,pk->i", Jxw, r)
        Hxd = torch.einsum("pki,pk->pi", Jxw, Jd)                      # [N, 8]
        Hdd = torch.sum(om * Jd * Jd, dim=-1)
        bd = torch.sum(om * Jd * r, dim=-1)
        E = torch.sum(torch.where(good[:, None], om * r * r * (2.0 - hw), 0.0))

        # α-prior before the snap, coupling prior after (reference: alphaOpt)
        n_pts = torch.clamp(torch.sum(good), min=1)
        if snapped:
            Hdd = Hdd + coupling
            bd = bd + coupling * (d - iR)
        else:
            Hdd = Hdd + alpha_w
            bd = bd + alpha_w * (d - 1.0)
            H = H.clone()
            H[:3, :3] += torch.diag(torch.full((3,), alpha_w, dtype=H.dtype,
                                               device=dev) * n_pts)
            b = b.clone()
            b[:3] += alpha_w * t * n_pts
        return H, b, Hxd, Hdd, bd, E, pt_ok, e_pt

    T, ab, d, iR, good = T0, ab0, idepth0, iR0, good0
    lam = torch.tensor(0.1, dtype=T0.dtype, device=dev)
    sysc = system(T, ab, d, iR, good)
    for _ in range(iters):
        H, b, Hxd, Hdd, bd, E, pt_ok, e_pt = sysc
        inv_dd = 1.0 / (Hdd * (1.0 + lam) + 1e-10)
        H_sc = torch.einsum("pi,p,pj->ij", Hxd, inv_dd, Hxd)
        b_sc = torch.einsum("pi,p->i", Hxd, inv_dd * bd)
        Hf = H.clone()
        torch.diagonal(Hf).mul_(1.0 + lam)
        Hf = Hf - H_sc
        Hf = Hf + 1e-6 * eye8 * torch.clamp(torch.trace(H), min=1.0)
        bf = b - b_sc
        dx = -torch.linalg.solve_ex(Hf, bf[:, None])[0][:, 0]
        dd = -(bd + Hxd @ dx) * inv_dd
        T_new = lie.se3_mul(lie.se3_exp(dx[:6]), T)
        ab_new = ab + dx[6:8]
        d_new = torch.clamp(d + dd, 1e-3, 50.0)
        # regularization toward the neighbour median (reference: optReg)
        iR_new = (1.0 - reg_weight) * d_new + reg_weight * _median_midpoint(iR[nbr])
        good_new = good & pt_ok
        sys2 = system(T_new, ab_new, d_new, iR_new, good_new)
        if ladder is not None:
            ladder.append((E, sys2[5]))
        accept = sys2[5] < E
        T = torch.where(accept, T_new, T)
        ab = torch.where(accept, ab_new, ab)
        d = torch.where(accept, d_new, d)
        iR = torch.where(accept, iR_new, iR)
        good = torch.where(accept, good_new, good)
        sysc = tuple(torch.where(accept, b_, a_) for a_, b_ in zip(sysc, sys2))
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-5), lam * 4.0)
    H, b, Hxd, Hdd, bd, E, pt_ok, e_pt = sysc
    return InitLevelOut(T=T, ab=ab, idepth=d, iR=iR, good=good & pt_ok,
                        energy=E, t_norm_sq=torch.sum(T[:3, 3] ** 2),
                        n_good=torch.sum(good & pt_ok))


class CoarseInitializer:
    """Host-side conductor for the bootstrap (reference: setFirst/trackFrame
    + FullSystem's initializer path)."""

    def __init__(self, cfg: LdsoConfig, intr, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.intr = torch.as_tensor(np.asarray(intr, np.float32), device=self.device)
        self.frame_id_first: Optional[int] = None
        self.snapped = False
        self.snapped_at = -1
        self.frames_tracked = 0

    def set_first(self, pyr, gsq):
        """Select bootstrap points on the first frame."""
        from scipy.spatial import cKDTree

        cfg = self.cfg
        n = cfg.shapes.init_points
        uv, _, valid = select.select_pixels(
            pyr[0], gsq[1], gsq[2], num_want=n, block=cfg.selector.block, pot=5,
            min_cut=cfg.selector.min_grad_hist_cut,
            min_add=cfg.selector.min_grad_hist_add)
        self.uv = uv
        self.valid0 = valid
        pat = pattern(self.device)
        self.colors = []  # per level host colors
        for l in range(cfg.shapes.pyr_levels):
            s = 0.5 ** l
            uv_l = uv * s + (0.5 * s - 0.5)
            self.colors.append(bilinear(pyr[l][..., 0], uv_l[:, None, :] + pat[None]))
        pts = uv.cpu().numpy()
        k = cfg.shapes.init_neighbors
        _, nbr = cKDTree(pts).query(pts, k=k + 1)
        self.neighbors = torch.as_tensor(nbr[:, 1:].astype(np.int32), device=self.device)
        self.idepth = torch.ones(n, dtype=torch.float32, device=self.device)
        self.iR = torch.ones(n, dtype=torch.float32, device=self.device)
        self.good = valid.cpu().numpy()
        self.T = torch.eye(4, dtype=torch.float32, device=self.device)
        self.ab = torch.zeros(2, dtype=torch.float32, device=self.device)
        self.pyr_first = pyr
        self.frames_tracked = 0
        self.snapped = False
        self.snapped_at = -1

    def track(self, pyr_new) -> dict:
        """Track a new frame against the first; returns a status dict."""
        cfg = self.cfg
        T, ab = self.T, self.ab
        # points get a fresh chance every frame; culled per level within this call
        d, iR, good = self.idepth, self.iR, self.valid0
        if not self.snapped:
            # until parallax snaps, translation and the depth field restart
            # from scratch each frame (pre-snap bias must not accumulate)
            T = T.clone()
            T[:3, 3] = 0.0
            d = torch.ones_like(d)
            iR = torch.ones_like(iR)
        out = None
        n_it = len(cfg.init.max_iterations)
        for l in range(cfg.shapes.pyr_levels - 1, -1, -1):
            out = init_level(
                pyr_new[l], self.uv, self.colors[l], self.neighbors,
                T, ab, d, iR, good, self.intr, level=l,
                iters=int(cfg.init.max_iterations[min(l, n_it - 1)]),
                snapped=self.snapped, alpha_w=cfg.init.alpha_w,
                alpha_k=cfg.init.alpha_k, coupling=cfg.init.coupling_weight,
                reg_weight=cfg.init.reg_weight, huber_th=cfg.init.huber_th)
            T, ab, d, iR, good = out.T, out.ab, out.idepth, out.iR, out.good

        self.T, self.ab = T, ab
        self.idepth, self.iR = d, iR
        self.good = out.good.cpu().numpy()
        self.frames_tracked += 1

        # snap test (reference: alphaEnergy > alphaK·npts)
        n_good_i = int(out.n_good)
        t_norm_sq = float(out.t_norm_sq)
        n_good = max(n_good_i, 1)
        if not self.snapped and cfg.init.alpha_w * t_norm_sq * n_good \
                > cfg.init.alpha_k * n_good:
            self.snapped = True
            self.snapped_at = self.frames_tracked
        done = self.snapped and (
            self.frames_tracked >= self.snapped_at + cfg.init.min_snap_frames)
        return dict(snapped=self.snapped, done=done, n_good=n_good_i,
                    energy=float(out.energy),
                    t_norm=float(np.sqrt(max(t_norm_sq, 0.0))))

    def results(self):
        """Final bootstrap output, rescaled to mean inverse depth 1."""
        good = np.asarray(self.good) & (self.idepth > 0).cpu().numpy()
        d = self.iR.cpu().numpy()
        mean_id = float(np.mean(d[good])) if good.any() else 1.0
        rescale = 1.0 / max(mean_id, 1e-6)
        T = self.T.cpu().numpy().astype(np.float64)
        # idepth *= rescale shrinks the world by 1/rescale: so must the baseline
        T[:3, 3] /= rescale
        return dict(T_first_to_new=T, uv=self.uv.cpu().numpy(), idepth=d * rescale,
                    good=good, ab=self.ab.cpu().numpy(), rescale=rescale)
