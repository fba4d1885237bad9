"""[The benchmark's reference: a frozen copy of the port's module of the
same name as of its first benchmark. Every dispatcher here calls the plain
torch version on any device; where the text below speaks of kernels, it
describes the port it was copied from.]

Marginalization: folding dying points and frames into the dense prior.

Port of ``ldso_tpu/ba/marginal.py``. Points flagged for marginalization
contribute their FEJ-linearized residuals (mode="fej" assembly on the
device) with their inverse depth Schur-eliminated; frames leaving the
window have their 8-block Schur-complemented out of HM/bM on the host in
float64 with sqrt-diagonal conditioning, exactly as the reference does.

The prior lives in delta-from-FEJ coordinates: energy(Δ) = ½ΔᵀHMΔ + bMᵀΔ.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ldso_bench.reference.residuals import assemble
from ldso_bench.reference.window import Window

# reference: setting_margWeightFac = 0.5·0.5
MARG_WEIGHT_FAC = 0.25


def marginalize_points(win: Window, marg_mask: np.ndarray, HM: np.ndarray,
                       bM: np.ndarray, cfg: LdsoConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Fold dying points into HM/bM: H_prior += Jᵀ Ω J − Schur(idepth),
    b_prior += Jᵀ Ω r₀ (reference: accumulateAF/SC in mode 2)."""
    marg_mask = np.asarray(marg_mask)
    if not marg_mask.any():
        return HM, bM
    win_m = win._replace(p_valid=win.p_valid & torch.as_tensor(marg_mask, device=win.x.device))
    sys = assemble(win_m, huber_th=cfg.ba.huber_th,
                   outlier_sum=cfg.ba.outlier_th_sum_component, mode="fej")
    H, b, Hxd, Hdd, bd = (a.cpu().numpy().astype(np.float64)
                          for a in (sys.H, sys.b, sys.H_xd, sys.H_dd, sys.b_d))
    active = marg_mask & (Hdd > 1e-8)
    inv_dd = np.where(active, 1.0 / np.maximum(Hdd, 1e-8), 0.0)
    H_sc = Hxd.T @ (Hxd * inv_dd[:, None])
    b_sc = Hxd.T @ (bd * inv_dd)
    return HM + MARG_WEIGHT_FAC * (H - H_sc), bM + MARG_WEIGHT_FAC * (b - b_sc)


def marginalize_frame(slot: int, HM: np.ndarray, bM: np.ndarray,
                      frame_prior_diag: np.ndarray | None = None,
                      frame_prior_delta: np.ndarray | None = None,
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Schur-complement a frame's 8-block out of the prior (host, f64):
    add the frame's own prior, condition with sqrt-diagonal scaling,
    pseudo-invert the dying block, eliminate, and zero the freed slot."""
    D = HM.shape[0]
    idx_v = np.arange(8 * slot, 8 * slot + 8)
    idx_k = np.setdiff1d(np.arange(D), idx_v)

    HM = HM.copy()
    bM = bM.copy()
    if frame_prior_diag is not None:
        HM[idx_v, idx_v] += frame_prior_diag
        bM[idx_v] += frame_prior_diag * (
            frame_prior_delta if frame_prior_delta is not None else 0.0)

    s = np.sqrt(np.abs(np.diag(HM)) + 10.0)
    s_inv = 1.0 / s
    Hs = HM * s_inv[:, None] * s_inv[None, :]
    bs = bM * s_inv

    Hvv = Hs[np.ix_(idx_v, idx_v)]
    # pseudo-inverse: the dying block can be rank-deficient
    Hvv_inv = np.linalg.pinv(0.5 * (Hvv + Hvv.T), rcond=1e-8)
    Hkv = Hs[np.ix_(idx_k, idx_v)]
    Hs_new = Hs[np.ix_(idx_k, idx_k)] - Hkv @ Hvv_inv @ Hkv.T
    bs_new = bs[idx_k] - Hkv @ (Hvv_inv @ bs[idx_v])

    HM_out = np.zeros_like(HM)
    bM_out = np.zeros_like(bM)
    HM_out[np.ix_(idx_k, idx_k)] = 0.5 * (Hs_new + Hs_new.T) * np.outer(s[idx_k], s[idx_k])
    bM_out[idx_k] = bs_new * s[idx_k]
    return HM_out, bM_out


def empty_prior(D: int) -> Tuple[np.ndarray, np.ndarray]:
    return np.zeros((D, D), dtype=np.float64), np.zeros(D, dtype=np.float64)
