"""[The benchmark's reference: a frozen copy of the port's module of the
same name as of its first benchmark. Every dispatcher here calls the plain
torch version on any device; where the text below speaks of kernels, it
describes the port it was copied from.]

Photometric residual / Jacobian evaluation and Gauss-Newton assembly.

Port of ``ldso_tpu/ba/residuals.py``. Every (point, target) pair in the
window is evaluated as one dense batch — here all F target slots at once
as a [P, F, 8] batch (the reference loops over the F slots) — and the
reduced camera system is assembled block by block.

First-Estimate-Jacobian semantics (as the reference):
  * geometric Jacobian factors (projection derivatives, adjoint
    transport, affine-transfer coefficient) are evaluated at the FEJ
    states: ``T_eval`` poses, ``x_zero`` affine, ``c_zero`` intrinsics,
    ``idepth_zero``;
  * the residual intensity lookup and image gradients use the CURRENT
    states.

State layout of the reduced system (D = 8F+4): columns [8·s : 8·s+8] =
frame slot s: [xi(6), a, b]; columns [8F:] = intrinsics [fx fy cx cy].

``assemble`` and ``energy_only`` dispatch on the device of the window:
the plain versions ``assemble_torch`` and ``energy_only_torch`` (torch
compositions) for CPU tensors, the CUDA kernel (``kernels/ba.py``, one
launch an evaluation that makes the pair tables too) for CUDA tensors; any
other device raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ldso_bench.reference.window import Window, pattern, state_delta
from ldso_bench.reference.interp import bilinear_packed, in_bounds, pack_corners
from ldso_bench.reference import lie


class BASystem(NamedTuple):
    """Everything the solver needs, plus per-pair diagnostics for the host."""

    H: torch.Tensor          # [D, D] reduced camera system (before Schur/prior)
    b: torch.Tensor          # [D] gradient Jᵀ Ω r
    H_xd: torch.Tensor       # [P, D] camera-idepth cross blocks
    H_dd: torch.Tensor       # [P] idepth Hessian
    b_d: torch.Tensor        # [P] idepth gradient
    energy: torch.Tensor     # scalar Huber energy (reference formula)
    e_pair: torch.Tensor     # [P, F] per (point, target) energy
    valid_pair: torch.Tensor # bool [P, F] pair produced a usable residual
    oob_pair: torch.Tensor   # bool [P, F] pair was masked-in but projected OOB
    num_res: torch.Tensor    # scalar count of valid pattern residuals


class PairPrecalc(NamedTuple):
    """Per (host, target) precomputed quantities, indexed [host, target]."""

    R_cur: torch.Tensor      # [F, F, 3, 3]
    t_cur: torch.Tensor      # [F, F, 3]
    R_fej: torch.Tensor      # [F, F, 3, 3]
    t_fej: torch.Tensor      # [F, F, 3]
    adj_fej: torch.Tensor    # [F, F, 6, 6] Adjoint of FEJ relative pose
    alpha_cur: torch.Tensor  # [F, F] e^{a_rel} at current affine states
    alpha_fej: torch.Tensor  # [F, F] e^{a_rel} at FEJ affine states
    b_host_cur: torch.Tensor # [F] current host b
    b_host_fej: torch.Tensor # [F] FEJ host b
    b_tgt_cur: torch.Tensor  # [F] current target b


def precompute_pairs(win: Window) -> PairPrecalc:
    T_cur = lie.se3_mul(lie.se3_exp(win.x[:, :6]), win.T_eval)
    Tc_inv = lie.se3_inverse(T_cur)
    Te_inv = lie.se3_inverse(win.T_eval)
    # rel[h, t] = T_t · T_h⁻¹
    rel_cur = torch.einsum("tij,hjk->htik", T_cur, Tc_inv)
    rel_fej = torch.einsum("tij,hjk->htik", win.T_eval, Te_inv)
    ea_cur = win.exposure * torch.exp(win.x[:, 6])
    ea_fej = win.exposure * torch.exp(win.x_zero[:, 6])
    return PairPrecalc(
        R_cur=rel_cur[..., :3, :3], t_cur=rel_cur[..., :3, 3],
        R_fej=rel_fej[..., :3, :3], t_fej=rel_fej[..., :3, 3],
        adj_fej=lie.se3_adjoint(rel_fej),
        alpha_cur=ea_cur[None, :] / ea_cur[:, None],
        alpha_fej=ea_fej[None, :] / ea_fej[:, None],
        b_host_cur=win.x[:, 7], b_host_fej=win.x_zero[:, 7],
        b_tgt_cur=win.x[:, 7],
    )


def _normalized_dirs(uv, intr):
    """Pixel(s) -> normalized host dirs [..., 3] (z = 1)."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _pose_jacobian(up, vp, new_id, fx, fy):
    """d(pixel)/d(left-increment of relative pose), [..., 2, 6]."""
    z = torch.zeros_like(up)
    row_u = torch.stack([new_id * fx, z, -new_id * up * fx,
                         -up * vp * fx, (1.0 + up * up) * fx, -vp * fx], dim=-1)
    row_v = torch.stack([z, new_id * fy, -new_id * vp * fy,
                         -(1.0 + vp * vp) * fy, up * vp * fy, up * fy], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def _cam_jacobian(up, vp, drescale, xh, R, fx, fy, intr):
    """d(pixel)/d(intrinsics fx fy cx cy), [..., 2, 4]: the direct
    target-projection dependence plus the host-backprojection chain."""
    fx0, fy0 = intr[0], intr[1]
    zero, one = torch.zeros_like(up), torch.ones_like(up)
    dxh = torch.stack([(-xh[..., 0] / fx0).expand_as(up), zero, -1.0 / fx0 * one,
                       zero], dim=-1)
    dyh = torch.stack([zero, (-xh[..., 1] / fy0).expand_as(up), zero,
                       -1.0 / fy0 * one], dim=-1)
    dX = R[..., :, 0:1] * dxh[..., None, :] + R[..., :, 1:2] * dyh[..., None, :]
    dup = drescale[..., None] * (dX[..., 0, :] - up[..., None] * dX[..., 2, :])
    dvp = drescale[..., None] * (dX[..., 1, :] - vp[..., None] * dX[..., 2, :])
    du_pix = fx * dup + torch.stack([up, zero, one, zero], dim=-1)
    dv_pix = fy * dvp + torch.stack([zero, vp, zero, one], dim=-1)
    return torch.stack([du_pix, dv_pix], dim=-2)


def _project_current(win: Window, pre: PairPrecalc, host):
    """Current projection of every point's 8 pattern samples into every
    target slot: (uvk [P, F, 8, 2], ok_pat [P, F, 8])."""
    H_img, W_img = win.images.shape[1], win.images.shape[2]
    fx, fy = win.c[0], win.c[1]
    uv_pat = win.p_uv[:, None, :] + pattern(win.p_uv.device)[None, :, :]
    xh_cur = _normalized_dirs(uv_pat, win.c)                           # [P, 8, 3]
    Xk = torch.einsum("pfij,pkj->pfki", pre.R_cur[host], xh_cur) \
        + pre.t_cur[host][:, :, None, :] * win.p_idepth[:, None, None, None]
    zk = Xk[..., 2]
    ok_z = zk > 1e-6
    safe_zk = torch.where(ok_z, zk, torch.ones_like(zk))
    uvk = torch.stack([fx * Xk[..., 0] / safe_zk + win.c[2],
                       fy * Xk[..., 1] / safe_zk + win.c[3]], dim=-1)
    ok_pat = in_bounds(uvk, W_img, H_img, 2.0) & ok_z                  # [P, F, 8]
    return uvk, ok_pat


def _photometric(win, pre, host, uvk, ok, packed, huber_th, outlier_sum):
    """Residuals, gradients and weights at projected samples."""
    F, P = win.num_frames, win.num_points
    frame = torch.arange(F, device=uvk.device)[None, :, None].expand(P, F, 8)
    uvk = torch.where(ok[..., None], uvk, 2.0)
    hit = bilinear_packed(packed, uvk, 3, frame=frame)                 # [P, F, 8, 3]
    a_cur = pre.alpha_cur[host]                                        # [P, F]
    bh_cur = pre.b_host_cur[host]                                      # [P]
    r = hit[..., 0] - pre.b_tgt_cur[None, :, None] - a_cur[..., None] * (
        win.p_color - bh_cur[:, None])[:, None, :]
    g = hit[..., 1:3]
    w_tgt = torch.sqrt(outlier_sum / (outlier_sum + torch.sum(g * g, dim=-1)))
    w_stat = 0.5 * (w_tgt + win.p_weight[:, None, :])
    abs_r = torch.abs(r)
    hw = torch.where(abs_r < huber_th, 1.0, huber_th / torch.clamp(abs_r, min=1e-12))
    omega = torch.where(ok, w_stat * w_stat * hw, 0.0)
    return r, g, hw, omega


def assemble(win: Window, huber_th: float = 9.0, outlier_sum: float = 2500.0,
             mode: str = "active") -> BASystem:
    """Linearize all residuals and assemble the Gauss-Newton system.

    mode="active": b uses current residuals (the BA path).
    mode="fej":    b uses residuals transported to the linearization point
                   r₀ = r − J·Δstate (the marginalization path).

    ``assemble_torch`` for CPU tensors, the CUDA kernel for CUDA tensors."""
    if mode not in ("active", "fej"):
        raise ValueError(f"unknown assemble mode {mode!r}")
    return assemble_torch(win, huber_th, outlier_sum, mode)


def energy_only(win: Window, huber_th: float = 9.0, outlier_sum: float = 2500.0):
    """Total Huber energy and residual count at the current state (no
    Jacobians): ``energy_only_torch`` for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    return energy_only_torch(win, huber_th, outlier_sum)


def ba_slot_tables(win: Window):
    """``precompute_pairs`` as flat tables: the pair table [F, F, 62]
    ([host, target]: R_cur 9, t_cur 3, R_fej 9, t_fej 3, adj_fej 36,
    alpha_cur, alpha_fej) and the slot table [F, 3] (b_host_cur, b_host_fej,
    b_tgt_cur), the values the plain version gathers per point: the
    yardstick of the tables the kernel makes (``kernels/ba.slot_tables_cuda``)."""
    pre = precompute_pairs(win)
    F = win.num_frames
    pair = torch.cat([pre.R_cur.reshape(F, F, 9), pre.t_cur, pre.R_fej.reshape(F, F, 9),
                      pre.t_fej, pre.adj_fej.reshape(F, F, 36), pre.alpha_cur[..., None],
                      pre.alpha_fej[..., None]], dim=-1)
    slot = torch.stack([pre.b_host_cur, pre.b_host_fej, pre.b_tgt_cur], dim=-1)
    return pair, slot


def assemble_torch(win: Window, huber_th: float = 9.0, outlier_sum: float = 2500.0,
                   mode: str = "active") -> BASystem:
    """``assemble``'s plain version (a torch composition): linearize all
    residuals and assemble the Gauss-Newton system in ``mode``."""
    F, P = win.num_frames, win.num_points
    dev = win.x.device
    H_img, W_img = win.images.shape[1], win.images.shape[2]
    pre = precompute_pairs(win)
    host = win.p_host.long()
    fx0, fy0 = win.c_zero[0], win.c_zero[1]
    oh_host = torch.nn.functional.one_hot(host, F).to(win.p_uv.dtype)  # [P, F]
    packed = pack_corners(win.images)                                  # [F, H, W, 12]

    uvk, ok_pat = _project_current(win, pre, host)

    # FEJ central projection for the shared geometric Jacobian
    R_fej, t_fej = pre.R_fej[host], pre.t_fej[host]                    # [P,F,3,3], [P,F,3]
    xh_fej_c = _normalized_dirs(win.p_uv, win.c_zero)                  # [P, 3]
    X0 = torch.einsum("pfij,pj->pfi", R_fej, xh_fej_c) \
        + t_fej * win.p_idepth_zero[:, None, None]
    z0 = X0[..., 2]
    ok_fej = z0 > 1e-6
    drescale = 1.0 / torch.where(ok_fej, z0, torch.ones_like(z0))
    up0 = X0[..., 0] * drescale
    vp0 = X0[..., 1] * drescale
    new_id0 = win.p_idepth_zero[:, None] * drescale
    ok_fej = ok_fej & in_bounds(torch.stack([fx0 * up0 + win.c_zero[2],
                                             fy0 * vp0 + win.c_zero[3]], dim=-1),
                                W_img, H_img, 2.0)
    Jp_pose = _pose_jacobian(up0, vp0, new_id0, fx0, fy0)              # [P, F, 2, 6]
    Jp_cam = _cam_jacobian(up0, vp0, drescale, xh_fej_c[:, None, :], R_fej,
                           fx0, fy0, win.c_zero)                       # [P, F, 2, 4]
    Jp_d = torch.stack([fx0 * drescale * (t_fej[..., 0] - t_fej[..., 2] * up0),
                        fy0 * drescale * (t_fej[..., 1] - t_fej[..., 2] * vp0)],
                       dim=-1)                                         # [P, F, 2]

    valid_k = (ok_pat & ok_fej[..., None] & win.res_mask[..., None]
               & win.p_valid[:, None, None] & win.frame_valid[None, :, None])
    r, g, hw, omega = _photometric(win, pre, host, uvk, valid_k, packed,
                                   huber_th, outlier_sum)

    Jt_pose = g @ Jp_pose                                              # [P, F, 8, 6]
    Jh_pose = -(Jt_pose @ pre.adj_fej[host])
    J_cam = g @ Jp_cam                                                 # [P, F, 8, 4]
    J_d = torch.einsum("pfkg,pfg->pfk", g, Jp_d)                       # [P, F, 8]

    # affine Jacobians at FEJ (dr/da_t, dr/db_t, dr/da_h, dr/db_h)
    a_fej = pre.alpha_fej[host]                                        # [P, F]
    col0 = (win.p_color - pre.b_host_fej[host][:, None])[:, None, :]   # [P, 1, 8]
    Ja_t = -a_fej[..., None] * col0
    Jb_t = -torch.ones_like(Ja_t)
    Ja_h = a_fej[..., None] * col0
    Jb_h = a_fej[..., None] * torch.ones_like(col0)
    target8 = torch.cat([Jt_pose, Ja_t[..., None], Jb_t[..., None]], dim=-1)
    host8 = torch.cat([Jh_pose, Ja_h[..., None], Jb_h[..., None]], dim=-1)
    e_k = omega * r * r * (2.0 - hw)

    if mode == "fej":
        delta = state_delta(win)
        dF = delta[: 8 * F].reshape(F, 8)
        dC = delta[8 * F:]
        jdelta = (torch.einsum("pfka,fa->pfk", target8, dF)
                  + torch.einsum("pfka,pa->pfk", host8, dF[host])
                  + torch.einsum("pfka,a->pfk", J_cam, dC)
                  + J_d * (win.p_idepth - win.p_idepth_zero)[:, None, None])
        r_used = r - jdelta
    elif mode == "active":
        r_used = r
    else:
        raise ValueError(f"unknown assemble mode {mode!r}")

    # block-structured H = JᵀΩJ (the [P, F, 8, D] row matrix is never built)
    t8w = omega[..., None] * target8
    h8w = omega[..., None] * host8
    c4w = omega[..., None] * J_cam
    A_tt = torch.einsum("pfka,pfkb->fab", t8w, target8)
    m_hh = torch.einsum("pfka,pfkb->pab", h8w, host8)
    A_hh = torch.einsum("pab,pg->gab", m_hh, oh_host)
    x_ht = torch.einsum("pfka,pfkb->pfab", h8w, target8)
    A_ht = torch.einsum("pfab,pg->gfab", x_ht, oh_host)                # [host, target]
    A_cc = torch.einsum("pfka,pfkb->ab", c4w, J_cam)
    A_tc = torch.einsum("pfka,pfkb->fab", t8w, J_cam)
    m_hc = torch.einsum("pfka,pfkb->pab", h8w, J_cam)
    A_hc = torch.einsum("pab,pg->gab", m_hc, oh_host)

    eye_f = torch.eye(F, dtype=r.dtype, device=dev)
    blocks = (torch.einsum("fab,fg->fgab", A_tt + A_hh, eye_f)
              + A_ht + A_ht.permute(1, 0, 3, 2))
    Hff = blocks.permute(0, 2, 1, 3).reshape(8 * F, 8 * F)
    A_fc = (A_tc + A_hc).reshape(8 * F, 4)
    H = torch.cat([torch.cat([Hff, A_fc], dim=1),
                   torch.cat([A_fc.T, A_cc], dim=1)], dim=0)

    wr = omega * r_used
    b_t = torch.einsum("pfka,pfk->fa", target8, wr)
    b_h = oh_host.T @ torch.einsum("pfka,pfk->pa", host8, wr)
    b_c = torch.einsum("pfka,pfk->a", J_cam, wr)
    b = torch.cat([(b_t + b_h).reshape(8 * F), b_c])

    wJd = omega * J_d
    hx_t = torch.einsum("pfka,pfk->pfa", target8, wJd)
    hx_h = torch.einsum("pfka,pfk->pa", host8, wJd)
    hx_f = hx_t + hx_h[:, None, :] * oh_host[..., None]
    hx_c = torch.einsum("pfka,pfk->pa", J_cam, wJd)
    H_xd = torch.cat([hx_f.reshape(P, 8 * F), hx_c], dim=1)
    H_dd = torch.sum(wJd * J_d, dim=(1, 2))
    b_d = torch.sum(wJd * r_used, dim=(1, 2))

    valid_pair = torch.any(valid_k, dim=-1)
    requested = win.res_mask & win.p_valid[:, None] & win.frame_valid[None, :]
    return BASystem(
        H=H, b=b, H_xd=H_xd, H_dd=H_dd, b_d=b_d,
        energy=torch.sum(e_k), e_pair=torch.sum(e_k, dim=-1),
        valid_pair=valid_pair, oob_pair=requested & ~valid_pair,
        num_res=torch.sum(valid_k),
    )


def energy_only_torch(win: Window, huber_th: float = 9.0, outlier_sum: float = 2500.0):
    """``energy_only``'s plain version: total Huber energy and residual
    count at the current state (no Jacobians) — the accept/reject
    evaluation of a trial GN step."""
    pre = precompute_pairs(win)
    host = win.p_host.long()
    uvk, ok_pat = _project_current(win, pre, host)
    ok = ok_pat & win.res_mask[..., None] & win.p_valid[:, None, None] \
        & win.frame_valid[None, :, None]
    r, _, hw, omega = _photometric(win, pre, host, uvk, ok, pack_corners(win.images),
                                   huber_th, outlier_sum)
    return torch.sum(omega * r * r * (2.0 - hw)), torch.sum(ok)
