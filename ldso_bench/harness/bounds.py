"""The least time the card could take for a hand kernel's work: the larger
of its bytes over the memory rate and its operations over the float32
rate, from the kernel's inputs and outputs. Frozen copies of
``chip_smoke.py``'s counts (``track_level_bound_ms``, ``_footprint_texels``,
``ba_assemble_bound_ms``, ``ba_samples``, the pyramid's bytes), so that the
work reads the same whichever kernel does it.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, at its 700 W limit.
"""

from __future__ import annotations

import torch

from ldso_bench.reference import residuals as res

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores

# csrc/track_level.cu's evaluate, per point: xh 4, X 18, z test 2,
# projection 3 + 4, bounds 4, bilinear sample 33, residual and Huber 9 (77);
# a point with omega > 0 also J 31 and the H / b / E sums 99 (130). One LM
# step: damping 27, LU of the 8x9 system 372, back substitution 64,
# negation 8, the SE(3) exponential and T_new 260, accept / lambda 20 (751)
TRACK_FLOPS_POINT, TRACK_FLOPS_OK, TRACK_FLOPS_STEP = 77, 130, 751
# csrc/ba.cu's ba_kernel, per sample as one lane does it: a requested
# sample's projection and bounds test 32; a valid sample 1000 (FEJ centre,
# (I, dx, dy), residual and weights, Jacobians, its terms of the pair's and
# the point's sums); mode fej 45 more; energy_only 60 a valid sample
K4_FLOPS_REQ, K4_FLOPS_VALID, K4_FLOPS_FEJ, K4_FLOPS_ENERGY = 32, 1000, 45, 60


def _ms(n_bytes: float, flops: float) -> float:
    return 1e3 * max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def pyramid_bound_ms(h: int, w: int, levels: int) -> float:
    """K1, one uint8 frame: the frame read once, each level's (I, dx, dy)
    stack and squared gradient written once (16 B a pixel)."""
    px = sum((h >> l) * (w >> l) for l in range(levels))
    return _ms(h * w + 16 * px, 0)


def _footprint_texels(lv, w: int, h: int, Ts) -> int:
    """Distinct texels whose bilinear corners an evaluation at each pose of
    ``Ts`` [M, 4, 4] reads (a point out of bounds reads those at (2, 2))."""
    _, uv, idepth, _, valid, _, _, intr = lv
    fx, fy, cx, cy = intr
    xh = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                      torch.ones_like(idepth)], -1)
    X = torch.einsum("mij,nj->mni", Ts[:, :3, :3], xh) + Ts[:, None, :3, 3] * idepth[:, None]
    ok_z = X[..., 2] > 1e-6
    sz = torch.where(ok_z, X[..., 2], torch.ones_like(X[..., 2]))
    un, vn = fx * (X[..., 0] / sz) + cx, fy * (X[..., 1] / sz) + cy
    inb = (un >= 2) & (un < w - 3) & (vn >= 2) & (vn < h - 3) & ok_z & valid
    two = torch.full_like(un, 2.0)
    u0 = torch.where(inb, un, two).floor().long().clamp(0, w - 1)
    v0 = torch.where(inb, vn, two).floor().long().clamp(0, h - 1)
    u1, v1 = (u0 + 1).clamp(max=w - 1), (v0 + 1).clamp(max=h - 1)
    return int(torch.cat([v0 * w + u0, v0 * w + u1, v1 * w + u0, v1 * w + u1],
                         -1).unique().numel())


def track_level_bound_ms(lv, w: int, h: int, T_final, n_iter, n_ok_sum) -> float:
    """K2, one level's LM loop as this run's data drove it: bytes of the
    texels read at the lanes' first and final poses (12 B each), the N
    points' uv, idepth, color and valid (17 B) and the lanes' inputs and
    outputs once; operations per lane TRACK_FLOPS_POINT for each point in
    each of its 1 + n_iter evaluations, TRACK_FLOPS_OK for each point with
    omega > 0 over them, TRACK_FLOPS_STEP an iteration."""
    n, k = lv[1].shape[0], lv[5].shape[0]
    texels = _footprint_texels(lv, w, h, torch.cat([lv[5], T_final]))
    n_bytes = 12 * texels + 17 * n + 16 + k * (64 + 8) + k * (64 + 8 + 4 + 24 + 4 + 8)
    it = int(n_iter.sum())
    flops = (TRACK_FLOPS_POINT * n * (k + it) + TRACK_FLOPS_OK * int(n_ok_sum.sum())
             + TRACK_FLOPS_STEP * it)
    return _ms(n_bytes, flops)


def track_frame_bound_ms(args, out) -> float:
    """K2, one tracked frame: the levels of a ``track_levels_cuda(pyr, ref,
    plan, intr_levels, T_inits, ab_init, ...)`` call with its outputs
    (``LevelsOut``, [levels, lanes, ...]), each level from the poses it
    started at: the hypotheses, then the previous level's lanes, the
    winner (``out.best``) at the first fine level."""
    pyr, ref, plan, intr_levels, T_inits, ab_init = args[:6]
    coarse, fine = plan
    total, T0, ab0 = 0.0, T_inits, ab_init.reshape(1, 2).expand(T_inits.shape[0], 2)
    best = int(out.best[0])
    prev = None
    for i, p in enumerate(list(coarse) + list(fine)):
        if prev is not None:
            lanes = T0.shape[0]
            T0, ab0 = out.T[prev][:lanes], out.ab[prev][:lanes]
            if i == len(coarse):
                T0, ab0 = T0[best:best + 1], ab0[best:best + 1]
        lanes = T0.shape[0]
        l = p.level
        lv = (pyr[l], ref.uv[l], ref.idepth[l], ref.color[l], ref.valid[l], T0, ab0,
              intr_levels[p.intr_row])
        total += track_level_bound_ms(lv, int(pyr[l].shape[1]), int(pyr[l].shape[0]),
                                      out.T[l][:lanes], out.n_iter[l][:lanes],
                                      out.n_ok_sum[l][:lanes])
        prev = l
    return total


def ba_samples(win) -> tuple:
    """Every sample's current pixel and test (uvk [P, F, 8, 2], ok_pat
    [P, F, 8]), as the plain linearization projects them."""
    pre = res.precompute_pairs(win)
    return res._project_current(win, pre, win.p_host.long())


def ba_bound_ms(win, mode: str, valid_pair=None) -> float:
    """K4, one evaluation of ``win`` (``mode`` "active", "fej" or "energy"):
    bytes of each point's inputs once, each slot's pose and state, the
    intrinsics, the distinct texels of the valid samples at 12 B, each
    output once; operations per requested and per valid sample (K4_FLOPS_*).
    ``valid_pair`` [P, F]: the evaluation's own (its ``BASystem``'s)."""
    win = res.Window(*win)
    F, h, w = win.images.shape[0], win.images.shape[1], win.images.shape[2]
    P, D = win.p_uv.shape[0], 8 * win.images.shape[0] + 4
    uvk, ok_pat = ba_samples(win)
    requested = win.res_mask & win.p_valid[:, None] & win.frame_valid[None, :]
    energy = mode == "energy"
    if energy:
        valid = ok_pat & requested[..., None]
    else:
        if valid_pair is None:
            valid_pair = res.assemble_torch(win, mode=mode).valid_pair
        valid = ok_pat & valid_pair[..., None]
    f = torch.nonzero(valid)[:, 1]
    uv = uvk[valid]
    u0 = uv[:, 0].floor().long().clamp(0, w - 1)
    v0 = uv[:, 1].floor().long().clamp(0, h - 1)
    u1, v1 = (u0 + 1).clamp(max=w - 1), (v0 + 1).clamp(max=h - 1)
    base = f * (h * w)
    n_texels = int(torch.cat([base + v0 * w + u0, base + v0 * w + u1, base + v1 * w + u0,
                              base + v1 * w + u1]).unique().numel())
    n_req, n_valid = 8 * int(requested.sum()), int(valid.sum())
    n_bytes = (P * (8 + 4 + (0 if energy else 4) + 32 + 32 + 4 + 1 + F)
               + F * (64 + 32 + 4 + (0 if energy else 32)) + F + 32 + 12 * n_texels
               + (12 if energy else 4 * (D * D + D + 1) + 8 + P * (4 * D + 8 + 6 * F)))
    flops = n_req * K4_FLOPS_REQ + n_valid * (
        K4_FLOPS_ENERGY if energy else K4_FLOPS_VALID + (K4_FLOPS_FEJ if mode == "fej" else 0))
    return _ms(n_bytes, flops)
