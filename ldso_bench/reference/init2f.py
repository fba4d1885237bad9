"""[The benchmark's reference: a frozen copy of the port's plain bootstrap
level (``init2f.init_level_torch``) as of its first benchmark, its system
lifted out so that the comparison can read the objective at any state.
Plain torch on any device.]

Gauss-Newton iterations of the two-frame bootstrap at one pyramid level
(reference: CoarseInitializer::trackFrame's loop over calcResAndGS /
doStep / optReg): the pose, the affine and every point's inverse depth,
an inverse-depth prior toward 1 before the parallax snap and a coupling
to the neighbour-regularized depth after it; a step is taken only where
the photometric energy falls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ldso_bench.reference import lie
from ldso_bench.reference.interp import bilinear33, in_bounds
from ldso_bench.reference.window import pattern


class InitLevelOut(NamedTuple):
    T: torch.Tensor
    ab: torch.Tensor
    idepth: torch.Tensor
    iR: torch.Tensor
    good: torch.Tensor
    energy: torch.Tensor
    t_norm_sq: torch.Tensor
    n_good: torch.Tensor


def level_intrinsics(intr, level):
    """fx_l = fx 2^-l, cx_l = (cx + 0.5) 2^-l - 0.5."""
    s = 0.5 ** level
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    return torch.stack([fx * s, fy * s, (cx + 0.5) * s - 0.5, (cy + 0.5) * s - 0.5], dim=-1)


def _median_midpoint(x):
    n = x.shape[-1]
    xs = torch.sort(x, dim=-1).values
    return (xs[..., (n - 1) // 2] + xs[..., n // 2]) * 0.5


def level_system(img3_new, uv, colors, intr0, level: int, snapped: bool,
                 alpha_w: float = 150.0 * 150.0, coupling: float = 1.0,
                 huber_th: float = 9.0, **_):
    """The level's system as a function of the state (T, ab, d, iR, good):
    (H, b, Hxd, Hdd, bd, E, pt_ok, e_pt); E is the objective the steps
    are gated on, the Huber-weighted photometric energy of the good points."""
    h, w = img3_new.shape[0], img3_new.shape[1]
    dev = uv.device
    s = 0.5 ** level
    uv_l = uv * s + (0.5 * s - 0.5)
    intr_l = level_intrinsics(intr0, level)
    fx, fy, cx, cy = intr_l[0], intr_l[1], intr_l[2], intr_l[3]
    uvp = uv_l[:, None, :] + pattern(dev)[None]
    xh = torch.stack([(uvp[..., 0] - cx) / fx, (uvp[..., 1] - cy) / fy,
                      torch.ones_like(uvp[..., 0])], dim=-1)

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
        J_pose = g[..., 0:1] * Jp_u + g[..., 1:2] * Jp_v
        J_a = (-torch.exp(ab[0]) * colors)[..., None]
        J_b = -torch.ones_like(colors)[..., None]
        Jx = torch.cat([J_pose, J_a, J_b], dim=-1)
        dre = 1.0 / zs
        Jd = (g[..., 0] * (fx * dre * (t[0] - t[2] * up))
              + g[..., 1] * (fy * dre * (t[1] - t[2] * vp)))
        Jxw = Jx * om[..., None]
        H = torch.einsum("pki,pkj->ij", Jxw, Jx)
        b = torch.einsum("pki,pk->i", Jxw, r)
        Hxd = torch.einsum("pki,pk->pi", Jxw, Jd)
        Hdd = torch.sum(om * Jd * Jd, dim=-1)
        bd = torch.sum(om * Jd * r, dim=-1)
        E = torch.sum(torch.where(good[:, None], om * r * r * (2.0 - hw), 0.0))
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

    return system


def init_level(img3_new, uv, colors, neighbors, T0, ab0, idepth0, iR0, good0,
               intr0, level: int, iters: int, snapped: bool,
               alpha_w: float = 150.0 * 150.0, alpha_k: float = 2.5e5,
               coupling: float = 1.0, reg_weight: float = 0.8,
               huber_th: float = 9.0) -> InitLevelOut:
    """``iters`` damped GN iterations at one level; one system evaluation
    an iteration (the accepted state's is carried)."""
    dev = uv.device
    system = level_system(img3_new, uv, colors, intr0, level, snapped, alpha_w=alpha_w,
                          coupling=coupling, huber_th=huber_th)
    nbr = neighbors.long()
    eye8 = torch.eye(8, dtype=T0.dtype, device=dev)
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
        iR_new = (1.0 - reg_weight) * d_new + reg_weight * _median_midpoint(iR[nbr])
        good_new = good & pt_ok
        sys2 = system(T_new, ab_new, d_new, iR_new, good_new)
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
