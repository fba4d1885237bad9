"""[The benchmark's reference: frozen copies of the port's seeding program
(``system._seed_program`` with ``select.select_pixels`` and the corner
part of ``loop/orb.detect``) and of the tracker reference's projection
(``system._project_points_to_slot``), as of its first benchmark. Plain
torch on any device.]

Candidate seeding of a keyframe: FAST-16 / Shi-Tomasi corners on a grid,
adaptive-threshold gradient pixels at three potential scales, and the
8-pattern colors and static gradient weights of both pools (reference:
makeNewTraces = FeatureDetector + PixelSelector + ImmaturePoint ctors).
"""

from __future__ import annotations

import numpy as np
import torch

from ldso_bench.reference import lie
from ldso_bench.reference.interp import bilinear33, in_bounds
from ldso_bench.reference.window import Window, pattern

# FAST-16 Bresenham circle of radius 3 (du, dv)
FAST_OFFSETS = np.asarray([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)
PATCH_R = 15


def _arc_score(mask, mag):
    m2 = torch.cat([mask, mask], dim=-1)
    g2 = torch.cat([mag, mag], dim=-1)
    best = torch.zeros(mag.shape[:-1], dtype=mag.dtype, device=mag.device)
    for s in range(16):
        w_ok = torch.all(m2[..., s:s + 9], dim=-1)
        w_min = torch.amin(g2[..., s:s + 9], dim=-1)
        best = torch.maximum(best, torch.where(w_ok, w_min, torch.zeros_like(w_min)))
    return best


def fast_score(img, threshold: float = 20.0):
    """[H, W] FAST-16 score: the best 9-contiguous arc's min |I_c - I_p|
    where every sample is brighter (darker) than the centre by more than
    the threshold; the circle wraps around the borders."""
    circ = torch.stack([torch.roll(img, (-int(dv), -int(du)), dims=(0, 1))
                        for du, dv in FAST_OFFSETS], dim=-1)
    d = circ - img[..., None]
    del circ
    return torch.maximum(_arc_score(d > threshold, d), _arc_score(d < -threshold, -d))


def _box3(x):
    out = torch.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + torch.roll(x, (dy, dx), dims=(0, 1))
    return out / 9.0


def shi_tomasi_score(dx, dy):
    a, b, c = _box3(dx * dx), _box3(dx * dy), _box3(dy * dy)
    tr = 0.5 * (a + c)
    return tr - torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))


def detect_corners(img3, max_features: int = 512, cell: int = 16, fast_th: float = 20.0):
    """(uv [K, 2], score [K], valid [K]) of the grid corners of a level-0
    (I, dx, dy) stack: a FAST hit scores its FAST score + 1e3, else the
    normalized Shi-Tomasi score; the first maximum of each cell, then a
    stable descending sort to ``max_features`` (zero-padded)."""
    img = img3[..., 0]
    h, w = img.shape
    dev = img.device
    score = fast_score(img, fast_th)
    st = shi_tomasi_score(img3[..., 1], img3[..., 2])
    score = torch.where(score > 0, score + 1e3, st / (st.max() + 1e-6))
    m = PATCH_R + 1
    score[:m, :] = 0
    score[-m:, :] = 0
    score[:, :m] = 0
    score[:, -m:] = 0
    ch, cw = h // cell, w // cell
    s = score[: ch * cell, : cw * cell].reshape(ch, cell, cw, cell)
    s = s.permute(0, 2, 1, 3).reshape(ch, cw, cell * cell)
    cidx = torch.argmax(s, dim=-1)
    cbest = torch.amax(s, dim=-1)
    cy = torch.arange(ch, device=dev)[:, None] * cell + cidx // cell
    cx = torch.arange(cw, device=dev)[None, :] * cell + cidx % cell
    flat_scores = cbest.reshape(-1)
    flat_uv = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)
    k = min(max_features, flat_scores.shape[0])
    top, idx = torch.sort(flat_scores, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    uv = flat_uv[idx].to(torch.float32)
    valid = top > 0
    if k < max_features:
        pad = max_features - k
        uv = torch.cat([uv, torch.zeros((pad, 2), dtype=uv.dtype, device=dev)])
        top = torch.cat([top, torch.zeros(pad, dtype=top.dtype, device=dev)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
    return uv, top, valid


def _quantile_linear(x, q: float, dim: int = -1):
    n = x.shape[dim]
    xs = torch.sort(x, dim=dim).values
    pos = torch.tensor(q, dtype=x.dtype) * torch.tensor(n - 1, dtype=x.dtype)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    lw = 1.0 - hw
    lo_v = xs.narrow(dim, int(lo), 1).squeeze(dim)
    hi_v = xs.narrow(dim, int(hi), 1).squeeze(dim)
    return lo_v * lw.to(x.device) + hi_v * hw.to(x.device)


def _block_quantile_threshold(gsq, block: int, cut: float, add: float):
    h, w = gsq.shape
    bh, bw = h // block, w // block
    g = torch.sqrt(gsq[: bh * block, : bw * block])
    blocks = g.reshape(bh, block, bw, block).permute(0, 2, 1, 3).reshape(bh, bw, -1)
    th = _quantile_linear(blocks, cut, dim=-1) + add
    thp = torch.nn.functional.pad(th[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    th_s = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            th_s = th_s + thp[1 + dy: 1 + dy + bh, 1 + dx: 1 + dx + bw]
    th_s = th_s / 9.0
    th_pix = th_s.repeat_interleave(block, 0).repeat_interleave(block, 1)
    th_full = torch.full((h, w), 1e9, dtype=gsq.dtype, device=gsq.device)
    th_full[: bh * block, : bw * block] = th_pix
    return th_full


def _hash_dirs(h: int, w: int, cell: int, seed: int):
    ch, cw = h // cell + 1, w // cell + 1
    iy = np.arange(ch)[:, None]
    ix = np.arange(cw)[None, :]
    a = (iy * 73856093 ^ ix * 19349663 ^ (seed * 83492791)) & 0xFFFF
    ang = a.astype(np.float64) / 65536.0 * 2 * np.pi
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def _cell_argmax(score, cell: int):
    h, w = score.shape
    ch, cw = h // cell, w // cell
    s = score[: ch * cell, : cw * cell].reshape(ch, cell, cw, cell)
    s = s.permute(0, 2, 1, 3).reshape(ch, cw, cell * cell)
    idx = torch.argmax(s, dim=-1)
    best = torch.amax(s, dim=-1)
    onehot = torch.nn.functional.one_hot(idx, cell * cell).to(score.dtype) \
        * (best > 0).to(score.dtype)[..., None]
    m = onehot.reshape(ch, cw, cell, cell).permute(0, 2, 1, 3).reshape(ch * cell, cw * cell)
    out = torch.zeros_like(score)
    out[: ch * cell, : cw * cell] = m
    return out


def _cell_has_winner(win, cell: int):
    h, w = win.shape
    ch, cw = h // cell, w // cell
    s = win[: ch * cell, : cw * cell].reshape(ch, cell, cw, cell)
    has = (s.sum(dim=(1, 3)) > 0).to(win.dtype)
    up = has.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    out = torch.zeros_like(win)
    out[: ch * cell, : cw * cell] = up
    return out


def select_pixels(pyr0, gsq1, gsq2, num_want: int, block: int = 32, pot: int = 5,
                  min_cut: float = 0.5, min_add: float = 7.0,
                  down_weight: float = 0.75, seed: int = 0):
    """Up to ``num_want`` candidate pixels (uv, score, valid), by score
    descending: a pixel wins its ``pot`` cell if its dithered directional
    gradient clears the block threshold; cells with no winner fall back to
    2·pot cells on level 1, then 4·pot on level 2."""
    h, w = pyr0.shape[0], pyr0.shape[1]
    dev = pyr0.device
    g = pyr0[..., 1:3]
    gsq0 = torch.sum(g * g, dim=-1)
    th0 = _block_quantile_threshold(gsq0, block, min_cut, min_add) ** 2
    dirs = torch.as_tensor(_hash_dirs(h, w, pot, seed), device=dev)
    iy = torch.arange(h, device=dev) // pot
    ix = torch.arange(w, device=dev) // pot
    d = dirs[iy[:, None], ix[None, :]]
    dir_score0 = torch.abs(torch.sum(g * d, dim=-1)) ** 2
    score0 = torch.where(gsq0 > th0, dir_score0 + gsq0, 0.0)
    win0 = _cell_argmax(score0, pot)
    gsq1_up = gsq1.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]
    score1 = torch.where(gsq1_up > th0 * down_weight ** 2, gsq1_up, 0.0)
    win1 = _cell_argmax(score1, 2 * pot) * (1.0 - _cell_has_winner(win0, 2 * pot))
    gsq2_up = gsq2.repeat_interleave(4, 0).repeat_interleave(4, 1)[:h, :w]
    score2 = torch.where(gsq2_up > th0 * down_weight ** 4, gsq2_up, 0.0)
    win2 = _cell_argmax(score2, 4 * pot) \
        * (1.0 - _cell_has_winner(torch.maximum(win0, win1), 4 * pot))
    total = win0 * (score0 + 3e8) + win1 * (score1 + 2e8) + win2 * (score2 + 1e8)
    total[:4, :] = 0
    total[-4:, :] = 0
    total[:, :4] = 0
    total[:, -4:] = 0
    scores, idx = torch.sort(total.reshape(-1), descending=True, stable=True)
    scores, idx = scores[:num_want], idx[:num_want]
    uv = torch.stack([idx % w, idx // w], dim=-1).to(torch.float32)
    return uv, scores, scores > 0


def sample_pattern(img3, uv, outlier_sum: float = 2500.0):
    """Host-pattern colors and static gradient weights of new points."""
    hit = bilinear33(img3, uv[:, None, :] + pattern(uv.device)[None])
    gsq = torch.sum(hit[..., 1:3] ** 2, dim=-1)
    return hit[..., 0], torch.sqrt(outlier_sum / (outlier_sum + gsq))


def seed_program(pyr0, pyr1, pyr2, cfg, seed: int) -> dict:
    """A keyframe's candidates: corners and gradient pixels with their
    pattern colors and weights (the fields of ``system._seed_program``)."""
    gsq1 = torch.sum(pyr1[..., 1:3] ** 2, dim=-1)
    gsq2 = torch.sum(pyr2[..., 1:3] ** 2, dim=-1)
    osum = float(cfg.ba.outlier_th_sum_component)
    out = {}
    if cfg.selector.corner_fraction > 0:
        c_uv, c_score, c_valid = detect_corners(pyr0, max_features=cfg.loop.max_features,
                                                fast_th=cfg.loop.orb_fast_th)
        c_color, c_weight = sample_pattern(pyr0, c_uv, outlier_sum=osum)
        out.update(corner_uv=c_uv, corner_score=c_score, corner_valid=c_valid,
                   corner_color=c_color, corner_weight=c_weight)
    uv, _, valid = select_pixels(
        pyr0, gsq1, gsq2, num_want=int(cfg.selector.desired_immature_density),
        block=cfg.selector.block, pot=5, min_cut=cfg.selector.min_grad_hist_cut,
        min_add=cfg.selector.min_grad_hist_add,
        down_weight=cfg.selector.grad_down_weight_per_level, seed=seed)
    color, weight = sample_pattern(pyr0, uv, outlier_sum=osum)
    out.update(sel_uv=uv, sel_valid=valid, sel_color=color, sel_weight=weight)
    return out


def project_points_to_slot(win: Window, slot: int):
    """Every active point projected into window slot ``slot``: (uv [P, 2],
    idepth [P], color [P], valid [P]), the tracker's reference map."""
    T = win.current_pose()
    T_rel = T[slot] @ lie.se3_inverse(T)[win.p_host.long()]
    fx, fy, cx, cy = win.c[0], win.c[1], win.c[2], win.c[3]
    xh = torch.stack([(win.p_uv[:, 0] - cx) / fx, (win.p_uv[:, 1] - cy) / fy,
                      torch.ones_like(win.p_uv[:, 0])], dim=-1)
    X = (T_rel[:, :3, :3] @ xh[..., None])[..., 0] + T_rel[:, :3, 3] * win.p_idepth[:, None]
    z = X[..., 2]
    okz = z > 1e-6
    zs = torch.where(okz, z, torch.ones_like(z))
    uvn = torch.stack([fx * X[..., 0] / zs + cx, fy * X[..., 1] / zs + cy], dim=-1)
    h, w = win.images.shape[1], win.images.shape[2]
    valid = win.p_valid & okz & in_bounds(uvn, w, h, 3.0) & (win.p_host != slot) \
        & torch.any(win.res_mask, dim=-1)
    color = bilinear33(win.images[slot], uvn)[..., 0]
    return uvn, win.p_idepth / zs, color, valid
