"""[The benchmark's reference: a frozen copy of the port's module of the
same name as of its first benchmark. Every dispatcher here calls the plain
torch version on any device; where the text below speaks of kernels, it
describes the port it was copied from.]

Per-frame programs: the fused track + trace step, single and batched.

Port of ``ldso_tpu/frame_step.py``. ``fused_step`` runs pyramid build →
constant-velocity prediction → batched motion-hypothesis ladder → winner
refinement → flow indicators → KF-decision score → affine transfer →
epipolar trace of the immature bank. The host reads one small ``diag``
vector per frame, laid out by the DIAG_* indices below (the winning
refToNew pose rides inside it).

``fused_batch`` does the same for B frames: the reference scans over the
frames inside one XLA program; here all B pyramids are ONE launch of the
pyramid kernel, and a host loop tracks and traces frame after frame with
the carry (prediction pair, relative affine, bank) staying on the device
— nothing is read back inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ldso_bench.reference import tracker
from ldso_bench.reference import trace as trace_mod
from ldso_bench.reference.bank import Bank
from ldso_bench.reference.pyramid import build_pyramid
from ldso_bench.reference import lie

# diag vector layout returned by fused_step
DIAG_RMSE0 = 0
DIAG_FRAC_SAT = 1
DIAG_FRAC_OOB = 2
DIAG_FLOW_T = 3
DIAG_FLOW_RT = 4
DIAG_FLOW_R = 5
DIAG_KF_DELTA = 6
DIAG_A_ABS = 7
DIAG_B_ABS = 8
DIAG_A_REL = 9
DIAG_B_REL = 10
DIAG_T = 11                      # [11:27) row-major refToNew SE3
DIAG_LEN = 27


class FusedStepOut(NamedTuple):
    pyr: tuple               # L × [H_l, W_l, 3] pyramid of the new frame
    gsq: tuple               # L × [H_l, W_l] squared gradient magnitude
    T: torch.Tensor          # [4, 4] refToNew SE3
    bank: Bank               # bank after tracing against this frame
    diag: torch.Tensor       # [DIAG_LEN] f32


def _track_core(img, ref, T_last, T_prelast, ab0, intr, new_exposure, cfg):
    """Shared tracking body. ``img`` [H, W] uint8 or f32 (widened by the
    pyramid build)."""
    pyr, gsq = build_pyramid(img, cfg.shapes.pyr_levels)
    return _track_pyr(pyr, gsq, ref, T_last, T_prelast, ab0, intr, new_exposure, cfg)


def _track_pyr(pyr, gsq, ref, T_last, T_prelast, ab0, intr, new_exposure, cfg):
    """Tracking body on a built pyramid."""
    # constant-velocity prediction from the previous two refToNew poses
    vel = lie.se3_mul(T_last, lie.se3_inverse(T_prelast))
    T_cv = lie.se3_mul(vel, T_last)
    hyps = tracker.motion_hypotheses(T_cv, num=cfg.shapes.num_hypotheses)
    tr = tracker.track_frame(pyr, ref, hyps, ab0, intr, cfg)

    # keyframe-decision score (weights premultiplied by nominal 640+480)
    tc = cfg.tracker
    h, w = pyr[0].shape[:2]
    norm = 1120.0 / (w + h)
    delta = tc.kf_global_weight * norm * (
        tc.max_shift_weight_t * tr.flow[0]
        + tc.max_shift_weight_r * tr.flow[2]
        + tc.max_shift_weight_rt * tr.flow[1]
    ) + tc.max_affine_weight * torch.abs(tr.ab[0])

    # absolute affine of the new frame from the relative track result
    alpha_rel = torch.exp(tr.ab[0])
    e_ref = torch.clamp(ref.exposure, min=1e-6)
    a_ref, b_ref = ref.aff_ab[0], ref.aff_ab[1]
    a_abs = torch.log(torch.clamp(
        alpha_rel * e_ref * torch.exp(a_ref) / max(float(new_exposure), 1e-6),
        min=1e-12))
    b_abs = tr.ab[1] + alpha_rel * b_ref

    diag = torch.cat([
        torch.stack([tr.rmse[0], tr.frac_saturated, tr.frac_oob,
                     tr.flow[0], tr.flow[1], tr.flow[2],
                     delta, a_abs, b_abs, tr.ab[0], tr.ab[1]]).to(torch.float32),
        tr.T.reshape(-1).to(torch.float32),
    ])
    return pyr, gsq, tr.T, (a_abs, b_abs), diag


def _trace_core(img3_new, bank, T_eval, x, exposure_all, T_new_cw, ab_abs,
                exposure_new, intr, cfg) -> Bank:
    """Epipolar trace of every immature point against the new frame:
    ``_trace_core_torch`` for CPU tensors, the CUDA kernel (one launch,
    ``kernels/trace.trace_bank_cuda``) for CUDA tensors."""
    return _trace_core_torch(img3_new, bank, T_eval, x, exposure_all, T_new_cw, ab_abs,
                             exposure_new, intr, cfg)


def _trace_kw(cfg) -> dict:
    tcfg = cfg.trace
    return dict(num_samples=cfg.shapes.epi_samples, gn_iters=tcfg.gn_iterations,
                max_pix_search_frac=tcfg.max_pix_search_frac, min_quality=tcfg.min_quality,
                step_size=tcfg.step_size, slack_interval=tcfg.trace_slack_interval,
                extra_slack=tcfg.extra_slack, gn_threshold=tcfg.gn_threshold,
                sweep_pattern=tcfg.sweep_pattern)


def trace_slot_tables(T_eval, x, exposure_all, T_new_cw, ab_abs, exposure_new):
    """Each window slot's hostToNew pose [F, 4, 4] and (alpha, beta)
    transfer to the new frame [F, 2]: the expressions
    ``_trace_core_torch`` evaluates per point, per slot (a point's values
    are its host slot's, gathered). The yardstick of the tables the trace
    kernel makes itself (``kernels/trace.trace_tables_cuda``)."""
    T_all = lie.se3_mul(lie.se3_exp(x[:, :6]), T_eval)           # [F,4,4]
    T_hn = T_new_cw @ lie.se3_inverse(T_all)                     # [F,4,4]
    ea = exposure_all * torch.exp(x[:, 6])
    alpha = (exposure_new * torch.exp(ab_abs[0])) / torch.clamp(ea, min=1e-12)
    beta = ab_abs[1] - alpha * x[:, 7]
    return T_hn, torch.stack([alpha, beta], dim=-1)


def _trace_core_torch(img3_new, bank, T_eval, x, exposure_all, T_new_cw, ab_abs,
                      exposure_new, intr, cfg, details=None) -> Bank:
    """The plain version of the trace kernel: ``trace.trace_points`` (its
    ``details`` passed on) and the bank update, in torch."""
    tcfg = cfg.trace
    hs = bank.host_slot.long()
    T_all = lie.se3_mul(lie.se3_exp(x[:, :6]), T_eval)           # [F,4,4]
    T_hn = (T_new_cw @ lie.se3_inverse(T_all))[hs]               # [N,4,4]

    ea_h = exposure_all[hs] * torch.exp(x[hs, 6])
    alpha = (exposure_new * torch.exp(ab_abs[0])) / torch.clamp(ea_h, min=1e-12)
    beta = ab_abs[1] - alpha * x[hs, 7]
    ab = torch.stack([alpha, beta], dim=-1)

    first = torch.isnan(bank.idepth_max)
    d_min = torch.where(first, 0.0, bank.idepth_min)
    d_max = torch.where(first, 1e8, bank.idepth_max)

    res = trace_mod.trace_points(
        img3_new, bank.uv, bank.color, d_min, d_max, bank.valid,
        T_hn, ab, intr,
        num_samples=cfg.shapes.epi_samples,
        gn_iters=tcfg.gn_iterations,
        max_pix_search_frac=tcfg.max_pix_search_frac,
        min_quality=tcfg.min_quality,
        step_size=tcfg.step_size,
        slack_interval=tcfg.trace_slack_interval,
        extra_slack=tcfg.extra_slack,
        gn_threshold=tcfg.gn_threshold,
        sweep_pattern=tcfg.sweep_pattern,
        details=details)

    st = res.status
    good = bank.valid & (st == trace_mod.GOOD)
    new_outlier = bank.outlier_count + (bank.valid & (st == trace_mod.OUTLIER)).to(torch.int32)
    # drop hopeless candidates: OOB at once, persistent outliers after 8 strikes
    dropped = bank.valid & ((st == trace_mod.OOB) | (new_outlier >= 8))
    return bank._replace(
        valid=bank.valid & ~dropped,
        idepth_min=torch.where(good, res.idepth_min, bank.idepth_min),
        idepth_max=torch.where(good, res.idepth_max, bank.idepth_max),
        quality=torch.where(bank.valid, res.quality, bank.quality),
        last_status=torch.where(bank.valid, st, bank.last_status),
        outlier_count=new_outlier.to(torch.int32),
    )


def fused_step(img, ref: tracker.TrackerRef, T_last, T_prelast, ab0,
               bank: Bank, T_eval, x, exposure_all, T_ref_cw,
               intr, new_exposure, cfg) -> FusedStepOut:
    """Track + trace: the tracked pose feeds the epipolar search without
    leaving the device; the host reads one diag vector per frame."""
    pyr, gsq, T, (a_abs, b_abs), diag = _track_core(
        img, ref, T_last, T_prelast, ab0, intr, new_exposure, cfg)
    T_new_cw = lie.se3_mul(T, T_ref_cw)
    new_bank = _trace_core(pyr[0], bank, T_eval, x, exposure_all, T_new_cw,
                           torch.stack([a_abs, b_abs]), new_exposure, intr, cfg)
    return FusedStepOut(pyr=tuple(pyr), gsq=tuple(gsq), T=T, bank=new_bank,
                        diag=diag)


class FusedBatchOut(NamedTuple):
    pyr: tuple               # L × [B, H_l, W_l, 3] stacked pyramids
    diags: torch.Tensor      # [B, DIAG_LEN] f32, one readback per B frames
    bank: Bank               # bank after tracing all B frames
    T_last: torch.Tensor     # [4, 4] last refToNew (device carry)
    T_prelast: torch.Tensor  # [4, 4]
    ab_rel: torch.Tensor     # [2] last relative affine (device carry)


def fused_batch(imgs, exposures, ref: tracker.TrackerRef, T_last, T_prelast,
                ab0, bank: Bank, T_eval, x, exposure_all, T_ref_cw,
                intr, cfg) -> FusedBatchOut:
    """Track + trace B frames. ``imgs`` [B, H, W] uint8 or f32 on the
    device; ``exposures`` a host sequence of B floats. The B pyramids are
    one batched build; the prediction pair, the relative-affine chain and
    the bank ride from frame to frame on the device exactly as they ride
    host state in the per-frame path. KF decisions read the stacked diags
    after the batch, so they lag by up to B-1 frames."""
    stride = max(int(cfg.trace.trace_every), 1)
    pyrs, gsqs = build_pyramid(imgs, cfg.shapes.pyr_levels)
    T_l, T_p, ab = T_last, T_prelast, ab0
    diags = []
    for it in range(imgs.shape[0]):
        expo = float(exposures[it])
        pyr, gsq = slice_pyr(pyrs, it), slice_pyr(gsqs, it)
        _, _, T, (a_abs, b_abs), diag = _track_pyr(
            pyr, gsq, ref, T_l, T_p, ab, intr, expo, cfg)
        # realtime work-shedding: trace only every ``stride``th frame
        if it % stride == 0:
            bank = _trace_core(pyr[0], bank, T_eval, x, exposure_all,
                               lie.se3_mul(T, T_ref_cw), torch.stack([a_abs, b_abs]),
                               expo, intr, cfg)
        T_l, T_p, ab = T, T_l, diag[DIAG_A_REL:DIAG_B_REL + 1]
        diags.append(diag)
    return FusedBatchOut(pyr=tuple(pyrs), diags=torch.stack(diags), bank=bank,
                         T_last=T_l, T_prelast=T_p, ab_rel=ab)


def slice_pyr(pyr_batch, idx: int) -> tuple:
    """Frame ``idx``'s levels out of a stacked pyramid (views, no copy)."""
    return tuple(p[idx] for p in pyr_batch)
