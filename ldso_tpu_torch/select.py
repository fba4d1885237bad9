"""Candidate pixel selection by adaptive gradient thresholds.

Port of ``ldso_tpu/select.py``: per-block gradient-magnitude quantile
thresholds, per-cell maximum selection at three potential scales (d, 2d,
4d) with a deterministic hashed direction dither, and a final top-k to a
fixed candidate capacity.

The selection is meant to be bitwise equal to the reference's, so the
arithmetic is ordered as it is there: the block quantile uses the same
linear-interpolation formula as ``jnp.quantile``, cell winners are the
first maximum on the same reshaped layout, and the top-k breaks ties
toward the lower flat index (a stable descending sort) as
``jax.lax.top_k`` does.
"""

from __future__ import annotations

import numpy as np
import torch


def _quantile_linear(x, q: float, dim: int = -1):
    """``jnp.quantile(x, q, axis=dim)`` (method "linear"), same formula:
    low·(1−w) + high·w over the sorted values."""
    n = x.shape[dim]
    xs = torch.sort(x, dim=dim).values
    pos = torch.tensor(q, dtype=x.dtype) * torch.tensor(n - 1, dtype=x.dtype)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    hw = pos - lo
    lw = 1.0 - hw
    lo_v = xs.narrow(dim, int(lo), 1).squeeze(dim)
    hi_v = xs.narrow(dim, int(hi), 1).squeeze(dim)
    return lo_v * lw.to(x.device) + hi_v * hw.to(x.device)


def _block_quantile_threshold(gsq, block: int, cut: float, add: float):
    """Per-block threshold = quantile(|grad|, cut) + add, upsampled to
    pixels with 3x3 block smoothing (reference: makeHists + smoothed ths)."""
    h, w = gsq.shape
    bh, bw = h // block, w // block
    g = torch.sqrt(gsq[: bh * block, : bw * block])
    blocks = g.reshape(bh, block, bw, block).permute(0, 2, 1, 3).reshape(bh, bw, -1)
    th = _quantile_linear(blocks, cut, dim=-1) + add                 # [bh, bw]
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
    """Deterministic per-cell unit direction (replaces the reference's
    randomPattern dither)."""
    ch, cw = h // cell + 1, w // cell + 1
    iy = np.arange(ch)[:, None]
    ix = np.arange(cw)[None, :]
    a = (iy * 73856093 ^ ix * 19349663 ^ (seed * 83492791)) & 0xFFFF
    ang = a.astype(np.float64) / 65536.0 * 2 * np.pi
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def _cell_argmax(score, cell: int):
    """Winner mask: per cell of size `cell`, the argmax pixel (if score>0)."""
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
    """[H, W] winner mask -> per-pixel flag: does my `cell`-cell contain a
    winner already?"""
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
    """Select up to num_want candidate pixels; returns (uv [num_want, 2] f32,
    score [num_want], valid [num_want] bool), sorted by score descending.

    A pixel wins its d-cell if its dithered directional gradient clears
    the level-0 threshold; cells with no winner fall back to 2d cells at
    level 1 (threshold x down_weight), then 4d at level 2."""
    h, w = pyr0.shape[0], pyr0.shape[1]
    dev = pyr0.device
    g = pyr0[..., 1:3]
    gsq0 = torch.sum(g * g, dim=-1)
    th0 = _block_quantile_threshold(gsq0, block, min_cut, min_add) ** 2

    dirs = torch.as_tensor(_hash_dirs(h, w, pot, seed), device=dev)
    iy = torch.arange(h, device=dev) // pot
    ix = torch.arange(w, device=dev) // pot
    d = dirs[iy[:, None], ix[None, :]]                                 # [H, W, 2]
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
    # border exclusion (pattern padding + interpolation margin)
    total[:4, :] = 0
    total[-4:, :] = 0
    total[:, :4] = 0
    total[:, -4:] = 0

    scores, idx = torch.sort(total.reshape(-1), descending=True, stable=True)
    scores, idx = scores[:num_want], idx[:num_want]
    uv = torch.stack([idx % w, idx // w], dim=-1).to(torch.float32)
    return uv, scores, scores > 0
