"""[The benchmark's reference: a frozen copy of the port's module of the
same name as of its first benchmark. Every dispatcher here calls the plain
torch version on any device; where the text below speaks of kernels, it
describes the port it was copied from.]

Immature-point epipolar depth tracing and activation GN.

Port of ``ldso_tpu/trace.py``: for every candidate point, search its
inverse-depth interval's epipolar segment in a new frame with the
pattern SSD at a FIXED number of samples, refine sub-pixel with a few GN
steps along the line, shrink [idepth_min, idepth_max], and classify
GOOD / OOB / OUTLIER / SKIPPED / BADCONDITION.

``trace_points`` and ``optimize_idepth_bank`` are torch compositions
(the reference's XLA-fused gather-and-reduce loops): on the card the bank's
two programs run as CUDA kernels instead (``kernels/trace.py``; the trace
through ``frame_step._trace_core``, the activation through
:func:`activate_candidates_device`), and these are their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ldso_bench.reference.window import pattern
from ldso_bench.reference.interp import (bilinear33, bilinear_packed, in_bounds,
                                           pack_corners)
from ldso_bench.reference import lie

# status codes (reference: ImmaturePointStatus)
GOOD, OOB, OUTLIER, SKIPPED, BADCONDITION, UNINITIALIZED = 0, 1, 2, 3, 4, 5

_INF = float("inf")


class TraceResult(NamedTuple):
    idepth_min: torch.Tensor   # [N]
    idepth_max: torch.Tensor   # [N]
    status: torch.Tensor       # [N] i32
    quality: torch.Tensor      # [N] best/second-best energy ratio
    best_uv: torch.Tensor      # [N, 2] matched position in the new frame
    best_idepth: torch.Tensor  # [N] idepth at the matched position


def trace_points(
    img3_new,                # [H, W, 3] new frame (level 0)
    uv,                      # [N, 2] host pixels
    color,                   # [N, 8] host pattern intensities
    idepth_min,              # [N]
    idepth_max,              # [N]
    valid,                   # [N] bool
    T_hn,                    # [4, 4] or [N, 4, 4] hostToNew SE3 (per point)
    ab_hn,                   # [2] or [N, 2] relative affine: I_n ≈ alpha·I_h + beta
    intr,                    # [4]
    num_samples: int = 64,
    gn_iters: int = 3,
    max_pix_search_frac: float = 0.027,
    outlier_energy: float = 1800.0,
    min_quality: float = 3.0,
    step_size: float = 1.0,
    slack_interval: float = 1.5,
    extra_slack: float = 0.1,
    gn_threshold: float = 0.1,
    sweep_pattern: int = 8,
    details: Optional[dict] = None,
) -> TraceResult:
    """The epipolar search of every point in the new frame. ``details``, if
    given, is filled with what the status decisions read (the sweep's
    samples, in-bounds mask and SSDs, the best sample, each GN step before
    its threshold, the positions it reaches, g_along, the new interval, the
    energy gate); it costs no extra work."""
    h, w = img3_new.shape[0], img3_new.shape[1]
    N = uv.shape[0]
    dev = uv.device
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    pat = pattern(dev)
    if T_hn.ndim == 2:
        T_hn = T_hn.expand(N, 4, 4)
    if ab_hn.ndim == 1:
        ab_hn = ab_hn.expand(N, 2)
    R, t = T_hn[:, :3, :3], T_hn[:, :3, 3]

    # central ray pr = K·R·K⁻¹·(u,v,1) in pixel-homogeneous form, Kt = K·t
    xh = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy,
                      torch.ones_like(uv[..., 0])], dim=-1)
    Rx = (R @ xh[..., None])[..., 0]
    pr = torch.stack([fx * Rx[..., 0] + cx * Rx[..., 2],
                      fy * Rx[..., 1] + cy * Rx[..., 2], Rx[..., 2]], dim=-1)
    Kt = torch.stack([fx * t[:, 0] + cx * t[:, 2],
                      fy * t[:, 1] + cy * t[:, 2], t[:, 2]], dim=-1)

    def project_at(d):
        ph = pr + d[..., None] * Kt
        z = ph[..., 2]
        ok = z > 1e-6
        z = torch.where(ok, z, torch.ones_like(z))
        return torch.stack([ph[..., 0] / z, ph[..., 1] / z], dim=-1), ok

    p_min, ok_min = project_at(idepth_min)
    p_max, ok_max = project_at(torch.clamp(idepth_max, max=1e8))
    max_search = max_pix_search_frac * (w + h)
    # unbounded (or behind-camera) far end: walk maxPixSearch along the
    # analytic epipolar direction d(uv)/d(idepth) at idepth_min
    z_min = pr[..., 2] + idepth_min * Kt[:, 2]
    epi = torch.stack([Kt[:, 0] * pr[..., 2] - pr[..., 0] * Kt[:, 2],
                       Kt[:, 1] * pr[..., 2] - pr[..., 1] * Kt[:, 2]], dim=-1)
    epi = epi * torch.sign(z_min)[..., None]
    epi_n = torch.linalg.norm(epi, dim=-1, keepdim=True)
    epi_unit = epi / torch.clamp(epi_n, min=1e-12)
    unbounded = ~ok_max | (idepth_max > 1e6)
    p_max = torch.where(unbounded[..., None], p_min + max_search * epi_unit, p_max)
    seg = p_max - p_min
    seg_len = torch.linalg.norm(seg, dim=-1)
    too_short = seg_len < slack_interval
    dir_ = seg / torch.clamp(seg_len, min=1e-8)[..., None]
    length = torch.clamp(seg_len, max=max_search)
    steps = torch.linspace(0.0, 1.0, num_samples, device=dev)
    sample_uv = p_min[:, None, :] + (length[:, None] * steps[None, :])[..., None] \
        * dir_[:, None, :]                                             # [N, K, 2]

    packed_I = pack_corners(img3_new[..., :1])                         # [H, W, 4]
    packed3 = pack_corners(img3_new)                                   # [H, W, 12]
    pred_full = ab_hn[:, 0:1] * color + ab_hn[:, 1:2]                  # [N, 8]
    sweep_idx = list(sweep_indices(sweep_pattern))
    pat_s = pat[sweep_idx]
    pred = pred_full[:, sweep_idx]
    samp_uv = sample_uv[:, :, None, :] + pat_s[None, None, :, :]       # [N, K, S, 2]
    inb = torch.all(in_bounds(samp_uv, w, h, 2.0), dim=-1)             # [N, K]
    samp = torch.where(inb[..., None, None], samp_uv, 2.0)
    hit_I = bilinear_packed(packed_I, samp, 1)[..., 0]                 # [N, K, S]
    diff = hit_I - pred[:, None, :]
    ssd = torch.sum(diff * diff, dim=-1)
    ssd = torch.where(inb, ssd, _INF)

    best_k = torch.argmin(ssd, dim=-1)          # first minimum, as jnp.argmin
    best_e = torch.amin(ssd, dim=-1)
    kk = torch.arange(num_samples, device=dev)[None, :]
    excl = torch.abs(kk - best_k[:, None]) <= 2
    second_e = torch.amin(torch.where(excl, _INF, ssd), dim=-1)
    quality = second_e / torch.clamp(best_e, min=1e-6)

    best_uv = torch.gather(sample_uv, 1, best_k[:, None, None].expand(N, 1, 2))[:, 0, :]

    positions, raw_steps = [best_uv], []
    # GN sub-pixel refinement along the line
    for _ in range(gn_iters):
        hitk = bilinear_packed(packed3, best_uv[:, None, :] + pat[None, :, :], 3)
        rk = hitk[..., 0] - pred_full
        gk = torch.sum(hitk[..., 1:3] * dir_[:, None, :], dim=-1)      # dI/ds
        Hs = torch.sum(gk * gk, dim=-1)
        bs = torch.sum(gk * rk, dim=-1)
        step = torch.clamp(-bs / torch.clamp(Hs, min=1e-6), -step_size, step_size)
        raw_steps.append(step)
        step = torch.where(torch.abs(step) < gn_threshold, 0.0, step)
        best_uv = best_uv + step[..., None] * dir_
        positions.append(best_uv)

    # matched pixel back to inverse depth on the better-conditioned axis
    err_px = 1.0 + 0.5 * step_size
    use_u = torch.abs(dir_[..., 0]) > torch.abs(dir_[..., 1])

    def idepth_from(uv_pt):
        du = (pr[..., 2] * uv_pt[..., 0] - pr[..., 0]) / (Kt[:, 0] - Kt[:, 2] * uv_pt[..., 0])
        dv = (pr[..., 2] * uv_pt[..., 1] - pr[..., 1]) / (Kt[:, 1] - Kt[:, 2] * uv_pt[..., 1])
        return torch.where(use_u, du, dv)

    d_lo = idepth_from(best_uv - err_px * dir_)
    d_hi = idepth_from(best_uv + err_px * dir_)
    new_min = torch.minimum(d_lo, d_hi)
    new_max = torch.maximum(d_lo, d_hi)
    best_idepth = idepth_from(best_uv)

    hit_best = bilinear_packed(packed3, best_uv, 3)
    g_along = torch.abs(torch.sum(hit_best[..., 1:3] * dir_, dim=-1))

    searched_oob = ~ok_min | ~torch.any(inb, dim=-1)
    gate = (outlier_energy * len(sweep_idx) / 8.0) * (1.0 + extra_slack)
    is_outlier = best_e > gate
    bad_cond = (g_along < 1.0) | (new_max < new_min) | (new_min < -0.1)
    low_quality = quality < min_quality

    status = torch.full((N,), GOOD, dtype=torch.int32, device=dev)
    for cond, code in ((low_quality, OUTLIER), (bad_cond, BADCONDITION),
                       (is_outlier, OUTLIER), (too_short, SKIPPED),
                       (searched_oob, OOB), (~valid, UNINITIALIZED)):
        status = torch.where(cond, code, status).to(torch.int32)

    if details is not None:
        details.update(samp=samp_uv, inb=inb, ssd=ssd, best_k=best_k, best_e=best_e,
                       seg_len=seg_len, dir=dir_, raw_steps=raw_steps, positions=positions,
                       g_along=g_along, new_min=new_min, new_max=new_max, gate=gate,
                       status=status, quality=quality, best_idepth=best_idepth)
    good = status == GOOD
    return TraceResult(
        idepth_min=torch.where(good, torch.clamp(new_min, min=0.0), idepth_min),
        idepth_max=torch.where(good, new_max, idepth_max),
        status=status, quality=quality, best_uv=best_uv, best_idepth=best_idepth)


def sweep_indices(sweep_pattern: int) -> tuple:
    """The pattern points the sweep scores: all 8 for ``sweep_pattern`` 8
    and more, the diamond (0, 3, 5, 7) for 4, else the first
    ``max(sweep_pattern, 1)`` of (0, 4, 7)."""
    if sweep_pattern >= 8:
        return tuple(range(8))
    if sweep_pattern == 4:
        return (0, 3, 5, 7)
    return (0, 4, 7)[: max(sweep_pattern, 1)]


def _huber(r, huber_th):
    abs_r = torch.abs(r)
    return torch.where(abs_r < huber_th, 1.0, huber_th / torch.clamp(abs_r, min=1e-12))


def optimize_idepth(win_images, frame_valid, T_rel, alpha, beta, uv, color,
                    idepth0, valid, intr, host_slot: int, iters: int = 3,
                    huber_th: float = 9.0):
    """1-dof GN on inverse depth against every valid window frame for
    candidates sharing one host. Returns (idepth, H_dd, energy, count)."""
    F = win_images.shape[0]
    h, w = win_images.shape[1], win_images.shape[2]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    uvp = uv[:, None, :] + pattern(uv.device)[None]
    xh = torch.stack([(uvp[..., 0] - cx) / fx, (uvp[..., 1] - cy) / fy,
                      torch.ones_like(uvp[..., 0])], dim=-1)           # [N, 8, 3]

    def system(d):
        Hd = torch.zeros_like(d)
        bd = torch.zeros_like(d)
        E = torch.zeros_like(d)
        cnt = torch.zeros_like(d)
        for f in range(F):
            ok_f = frame_valid[f] & (f != host_slot)
            R, t = T_rel[f, :3, :3], T_rel[f, :3, 3]
            X = xh @ R.T + t * d[:, None, None]
            z = X[..., 2]
            okz = z > 1e-6
            zs = torch.where(okz, z, torch.ones_like(z))
            up, vp = X[..., 0] / zs, X[..., 1] / zs
            uvn = torch.stack([fx * up + cx, fy * vp + cy], dim=-1)
            inb = in_bounds(uvn, w, h, 2.0) & okz & ok_f & valid[:, None]
            hit = bilinear33(win_images[f], uvn)
            r = hit[..., 0] - alpha[f] * color - beta[f]
            dre = 1.0 / zs
            Jd = hit[..., 1] * (fx * dre * (t[0] - t[2] * up)) \
                + hit[..., 2] * (fy * dre * (t[1] - t[2] * vp))
            hw = _huber(r, huber_th)
            om = torch.where(inb, hw, 0.0)
            Hd = Hd + torch.sum(om * Jd * Jd, dim=-1)
            bd = bd + torch.sum(om * Jd * r, dim=-1)
            E = E + torch.sum(om * r * r * (2.0 - hw), dim=-1)
            cnt = cnt + torch.sum(inb, dim=-1)
        return Hd, bd, E, cnt

    d = idepth0
    for _ in range(iters):
        Hd, bd, E, cnt = system(d)
        d = torch.clamp(d - bd / (Hd + 1e-6), 1e-5, 50.0)
    Hd, bd, E, cnt = system(d)
    return d, Hd, E, cnt


def optimize_idepth_bank(win_images, frame_valid, T_all, x_affine, exposure_all,
                         uv, color, idepth0, valid, host_slot, intr,
                         iters: int = 3, huber_th: float = 9.0,
                         details: Optional[dict] = None):
    """Per-point-host 1-dof GN on inverse depth against every window slot
    (activation of immature points). Relative transforms and affine
    transfer are gathered per point. All F target slots are evaluated as
    one batch through the corner-packed window images. ``details``, if
    given, gets ``samples``: per evaluation the positions [N, F, 8, 2] and
    the samples that count [N, F, 8]."""
    F = win_images.shape[0]
    h, w = win_images.shape[1], win_images.shape[2]
    N = uv.shape[0]
    dev = uv.device
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    hs = host_slot.long()
    uvp = uv[:, None, :] + pattern(dev)[None]
    xh = torch.stack([(uvp[..., 0] - cx) / fx, (uvp[..., 1] - cy) / fy,
                      torch.ones_like(uvp[..., 0])], dim=-1)           # [N, 8, 3]

    T_inv_h = lie.se3_inverse(T_all)[hs]                               # [N, 4, 4]
    ea = exposure_all * torch.exp(x_affine[:, 6])                      # [F]
    ea_h = ea[hs]
    b_h = x_affine[hs, 7]
    packed = pack_corners(win_images)                                  # [F, H, W, 12]

    T_rel = torch.einsum("fij,pjk->pfik", T_all, T_inv_h)              # [N, F, 4, 4]
    R, t = T_rel[..., :3, :3], T_rel[..., :3, 3]
    alpha = ea[None, :] / torch.clamp(ea_h, min=1e-12)[:, None]        # [N, F]
    beta = x_affine[None, :, 7] - alpha * b_h[:, None]
    fr = torch.arange(F, device=dev)
    ok_f = frame_valid[None, :] & (hs[:, None] != fr[None, :]) & valid[:, None]
    RX = torch.einsum("pfij,pkj->pfki", R, xh)                         # [N, F, 8, 3]
    frame = fr[None, :, None].expand(N, F, 8)

    def system(d):
        X = RX + t[:, :, None, :] * d[:, None, None, None]
        z = X[..., 2]
        okz = z > 1e-6
        zs = torch.where(okz, z, torch.ones_like(z))
        up, vp = X[..., 0] / zs, X[..., 1] / zs
        uvn = torch.stack([fx * up + cx, fy * vp + cy], dim=-1)
        inb = in_bounds(uvn, w, h, 2.0) & okz & ok_f[..., None]
        if details is not None:
            details.setdefault("samples", []).append((uvn, inb))
        hit = bilinear_packed(packed, uvn, 3, frame=frame)             # [N, F, 8, 3]
        r = hit[..., 0] - alpha[..., None] * color[:, None, :] - beta[..., None]
        dre = 1.0 / zs
        Jd = hit[..., 1] * (fx * dre * (t[..., 0:1] - t[..., 2:3] * up)) \
            + hit[..., 2] * (fy * dre * (t[..., 1:2] - t[..., 2:3] * vp))
        hw = _huber(r, huber_th)
        om = torch.where(inb, hw, 0.0)
        return (torch.sum(om * Jd * Jd, dim=(1, 2)),
                torch.sum(om * Jd * r, dim=(1, 2)),
                torch.sum(om * r * r * (2.0 - hw), dim=(1, 2)),
                torch.sum(inb, dim=(1, 2)).to(d.dtype))

    d = idepth0
    for _ in range(iters):
        Hd, bd, E, cnt = system(d)
        d = torch.clamp(d - bd / (Hd + 1e-6), 1e-5, 50.0)
    Hd, bd, E, cnt = system(d)
    return dict(idepth=d, H_dd=Hd, energy=E, count=cnt)


def activate_candidates_device(win_images, frame_valid, T_all, x_affine,
                               exposure_all, bank, intr, min_quality: float,
                               iters: int = 3, huber_th: float = 9.0):
    """:func:`optimize_idepth_bank` with the activation-candidate mask and
    initial idepth computed from the live bank: ``activate_candidates_torch``
    for CPU tensors, the CUDA kernel (one launch,
    ``kernels/trace.activate_bank_cuda``) for CUDA tensors. Returns a dict
    of idepth, H_dd, energy, count [N] float32 and can [N] bool."""
    args = (win_images, frame_valid, T_all, x_affine, exposure_all, bank, intr, min_quality)
    return activate_candidates_torch(*args, iters=iters, huber_th=huber_th)


def activation_slot_tables(T_all, x_affine, exposure_all):
    """The relative poses [F, F, 4, 4] ([f, h] = T_all[f] T_all[h]^-1) and
    the affine transfers alpha, beta [F, F] (host h to target f): the
    expressions :func:`optimize_idepth_bank` evaluates per point, per slot
    pair. The yardstick of the tables the activation kernel makes itself
    (``kernels/trace.activation_tables_cuda``)."""
    T_rel = torch.einsum("fij,hjk->fhik", T_all, lie.se3_inverse(T_all)).contiguous()
    ea = exposure_all * torch.exp(x_affine[:, 6])                      # [F]
    alpha = ea[:, None] / torch.clamp(ea, min=1e-12)[None, :]          # [f, h]
    beta = x_affine[:, None, 7] - alpha * x_affine[None, :, 7]
    return T_rel, alpha.contiguous(), beta.contiguous()


def activate_candidates_torch(win_images, frame_valid, T_all, x_affine,
                              exposure_all, bank, intr, min_quality: float,
                              iters: int = 3, huber_th: float = 9.0,
                              details: Optional[dict] = None):
    """The plain version of the activation kernel: the candidate mask and
    initial idepth, then :func:`optimize_idepth_bank` (``details`` passed
    on), in torch."""
    can = (bank.valid & (bank.last_status == GOOD)
           & (bank.quality > min_quality)
           & ~torch.isnan(bank.idepth_max)
           & ((bank.idepth_max + bank.idepth_min) > 0))
    d0 = torch.clamp(0.5 * (torch.where(can, bank.idepth_min, 0.0)
                            + torch.where(can, bank.idepth_max, 1.0)), 1e-3, 50.0)
    out = optimize_idepth_bank(
        win_images, frame_valid, T_all, x_affine, exposure_all,
        bank.uv, bank.color, d0, can, bank.host_slot, intr,
        iters=iters, huber_th=huber_th, details=details)
    out["can"] = can
    return out
