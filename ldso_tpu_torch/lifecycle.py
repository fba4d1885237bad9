"""Keyframe lifecycle programs: activation + seed merge.

Port of ``ldso_tpu/lifecycle.py``:
  * :func:`kf_activate` — activation GN (idepth refinement against the
    whole window), quality/energy/Hessian gates, the occupancy-cell
    spacing gate, top-``n_want`` selection, and the scatter into free
    window point slots;
  * :func:`compute_seed_patch` — merges the corner and gradient seeds
    (corner-biased share, 2-px dedup) and assigns free bank slots to them
    after the keyframe's drops, emitting the arguments for
    :func:`ldso_tpu_torch.core.bank.apply_patch`.
"""

from __future__ import annotations

import numpy as np
import torch

from ldso_tpu_torch import trace as trace_mod
from ldso_tpu_torch.config import LdsoConfig
from ldso_tpu_torch.core.bank import Bank
from ldso_tpu_torch.core.scatter import scatter_drop
from ldso_tpu_torch.core.window import Window
from ldso_tpu_torch.math import lie

# layout of the kf_activate stats vector
ST_N_IMM = 0          # valid candidates in the bank
ST_N_IMM_GOOD = 1     # last trace GOOD
ST_N_IMM_Q = 2        # GOOD and above the quality gate
ST_N_ACT = 3          # activated into the window this KF
ST_N_CORNER_ACT = 4   # of those, corner-seeded
ST_N_ACTIVE = 5       # window active points AFTER activation
ST_LEN = 6


def _project_to_slot(T_all, c, uv, idepth, host_slot, slot: int):
    """Project host-frame pixels (uv, idepth, host) into window frame
    ``slot``; returns uv' [N,2] and a positive-depth mask."""
    fx, fy, cx, cy = c[0], c[1], c[2], c[3]
    T_rel = T_all[slot] @ lie.se3_inverse(T_all)[host_slot.long()]
    xh = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                      torch.ones_like(uv[:, 0])], dim=-1)
    X = (T_rel[:, :3, :3] @ xh[..., None])[..., 0] + T_rel[:, :3, 3] * idepth[:, None]
    z = X[..., 2]
    ok = z > 1e-6
    zs = torch.where(ok, z, torch.ones_like(z))
    return torch.stack([fx * X[..., 0] / zs + cx, fy * X[..., 1] / zs + cy], dim=-1), ok


def kf_activate(win: Window, bank: Bank, intr, new_slot: int, mad_px: float,
                cfg: LdsoConfig):
    """Promote the best immature candidates to active window points.

    Candidates must be GOOD and high-quality, pass the energy/Hessian
    gates after an idepth GN against the whole window, and be spaced by
    an occupancy-cell gate (cell ``mad_px``) in the new keyframe's image;
    the best ``desired_point_density − n_active`` fill free window slots.
    Returns (window', bank_drop_mask [N], stats [ST_LEN] f32)."""
    dev = win.x.device
    T_all = win.current_pose()
    res = trace_mod.activate_candidates_device(
        win.images, win.frame_valid, T_all, win.x, win.exposure,
        bank, intr, float(cfg.trace.min_quality), iters=3,
        huber_th=float(cfg.ba.huber_th))
    can, d, Hd = res["can"], res["idepth"], res["H_dd"]
    E, cnt = res["energy"], res["count"]
    ok = can & (Hd > cfg.ba.min_idepth_hessian) & (cnt >= 8) \
        & (E < cfg.ba.outlier_th * torch.clamp(cnt, min=1))

    N = bank.capacity
    P = win.num_points
    # quality-descending order with gated-out rows last (stable, as jnp.argsort)
    order = torch.argsort(torch.where(ok, -bank.quality, float("inf")), stable=True)
    ok_s = ok[order]
    uv_s = bank.uv[order]
    d_s = d[order]
    host_s = bank.host_slot[order].to(torch.int32)

    # occupancy-cell spacing gate in the new KF's image
    mad_px = float(np.float32(mad_px))       # the reference passes it as f32
    cell = max(mad_px, 1.0)
    cand_uv, _ = _project_to_slot(T_all, win.c, uv_s, d_s, host_s, new_slot)
    act_uv, _ = _project_to_slot(T_all, win.c, win.p_uv, win.p_idepth,
                                 win.p_host, new_slot)

    def keys(uv):
        cells = torch.clamp(torch.floor(uv / cell), -1024, 1024).to(torch.int32)
        return cells[:, 0] * 2048 + cells[:, 1]

    ck = keys(cand_uv)
    ak = keys(act_uv)
    occupied = torch.any((ck[:, None] == ak[None, :]) & win.p_valid[None, :], dim=1)
    # first occurrence per cell among gated candidates in quality order
    ii = torch.arange(N, device=dev)
    dup = torch.any((ck[:, None] == ck[None, :]) & ok_s[None, :]
                    & (ii[None, :] < ii[:, None]), dim=1)
    # the host ladder switches spacing off when mad < 0.25 (mad_px = 2·mad)
    keep = ok_s & (~(dup | occupied) | (mad_px < 0.5))

    # top n_want into free window slots
    n_active = torch.sum(win.p_valid)
    n_want = torch.clamp(int(cfg.selector.desired_point_density) - n_active,
                         min=torch.zeros_like(n_active), max=P - n_active)
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    chosen = keep & (rank < n_want)
    slot_order = torch.argsort(win.p_valid.to(torch.int32), stable=True)
    target = torch.where(chosen, slot_order[torch.clamp(rank, 0, P - 1)], P)

    idep = torch.clamp(d_s, 1e-5, 50.0)
    res_rows = win.frame_valid[None, :] & (
        torch.arange(win.num_frames, device=dev)[None, :] != host_s[:, None])
    win2 = win._replace(
        p_valid=scatter_drop(win.p_valid, target, True),
        p_host=scatter_drop(win.p_host, target, host_s),
        p_uv=scatter_drop(win.p_uv, target, uv_s),
        p_color=scatter_drop(win.p_color, target, bank.color[order]),
        p_weight=scatter_drop(win.p_weight, target, bank.weight[order]),
        p_idepth=scatter_drop(win.p_idepth, target, idep),
        p_idepth_zero=scatter_drop(win.p_idepth_zero, target, idep),
        res_mask=scatter_drop(win.res_mask, target, res_rows),
    )

    # bank drop mask back in UNSORTED order
    drop = torch.zeros(N, dtype=torch.bool, device=dev)
    drop[order] = chosen

    good = bank.valid & (bank.last_status == trace_mod.GOOD)
    stats = torch.stack([
        torch.sum(bank.valid), torch.sum(good),
        torch.sum(good & (bank.quality > cfg.trace.min_quality)),
        torch.sum(chosen), torch.sum(bank.is_corner[order] & chosen),
        n_active + torch.sum(chosen),
    ]).to(torch.float32)
    return win2, drop, stats


def compute_seed_patch(bank: Bank, seed: dict, host_slot: int, dying_mask,
                       cfg: LdsoConfig):
    """Build apply_patch args for a keyframe's bank surgery: drop
    candidates hosted by dying frames, merge corner + gradient seeds
    (corner-biased fraction, 2-px dedup — reference: makeNewTraces
    ordering), and assign free bank slots (after the drops) in rank order.

    ``seed`` is the ``system._seed_program`` output. Returns (drop_mask [N],
    slots [N] (padded with N = dropped), uv [N,2], color [N,8],
    weight [N,8], is_corner [N])."""
    N = bank.capacity
    dev = bank.uv.device
    drop = bank.valid & dying_mask[bank.host_slot.long()]
    valid_after = bank.valid & ~drop
    n_want = torch.clamp(N - torch.sum(valid_after),
                         max=int(cfg.selector.desired_immature_density))
    s_uv, s_val = seed["sel_uv"], seed["sel_valid"]
    s_col, s_wgt = seed["sel_color"], seed["sel_weight"]

    if cfg.selector.corner_fraction > 0 and "corner_uv" in seed:
        c_uv = seed["corner_uv"]
        # true FAST hits only (detect() marks them with a +1e3 offset)
        fv = seed["corner_valid"] & (seed["corner_score"] > 1e3)
        # float32 product truncated, as the reference's int32·float on device
        n_c = (n_want * cfg.selector.corner_fraction).to(torch.int64)
        c_acc = fv & (torch.cumsum(fv.to(torch.int64), 0) - 1 < n_c)
        # gradient picks within 2 px of an accepted corner are duplicates
        d2 = torch.sum((s_uv[:, None, :] - c_uv[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(c_acc[None, :], d2, torch.full_like(d2, float("inf")))
        s_keep = s_val & (torch.amin(d2, dim=1) > 4.0)
        uv = torch.cat([c_uv, s_uv])
        col = torch.cat([seed["corner_color"], s_col])
        wgt = torch.cat([seed["corner_weight"], s_wgt])
        acc = torch.cat([c_acc, s_keep])
        is_corner = torch.cat([torch.ones(c_uv.shape[0], dtype=torch.bool, device=dev),
                               torch.zeros(s_uv.shape[0], dtype=torch.bool, device=dev)])
    else:
        uv, col, wgt, acc = s_uv, s_col, s_wgt, s_val
        is_corner = torch.zeros(s_uv.shape[0], dtype=torch.bool, device=dev)

    rank = torch.cumsum(acc.to(torch.int64), 0) - 1
    take = acc & (rank < n_want)
    slot_order = torch.argsort(valid_after.to(torch.int32), stable=True)
    # compact the accepted seeds into N rows by rank (rows >= N dropped)
    dest = torch.where(take, rank, N)
    out_slots = scatter_drop(torch.full((N,), N, dtype=torch.int32, device=dev), dest,
                             slot_order[torch.clamp(rank, 0, N - 1)].to(torch.int32))
    out_uv = scatter_drop(torch.zeros((N, 2), dtype=torch.float32, device=dev), dest, uv)
    out_col = scatter_drop(torch.zeros((N, 8), dtype=torch.float32, device=dev), dest, col)
    out_wgt = scatter_drop(torch.ones((N, 8), dtype=torch.float32, device=dev), dest, wgt)
    out_corner = scatter_drop(torch.zeros(N, dtype=torch.bool, device=dev), dest, is_corner)
    return drop, out_slots, out_uv, out_col, out_wgt, out_corner
