"""Gauss-Newton solve of the reduced camera system + idepth backsubstitution.

Port of ``ldso_tpu/ba/solve.py``. The inverse-depth blocks are eliminated
per point by Schur complement, the small (8F+4)² damped system is solved
densely, the scale gauge is projected out of the step, and idepth
increments come back by backsubstitution. The anchor keyframe's pose is
hard-fixed.

``run_ba`` drives the reference's energy-gated LM ladder
(``_ba_loop_device``) as a host loop: a step is accepted only when the
total energy drops (λ·0.25, floor 1e-7); a rejected step multiplies λ by
4; the loop stops at λ > 1e2, on a small accepted step once
``min_iterations`` have run, or at ``max_iterations``. The accepted
state's linearization is carried, so every iteration costs one
``assemble``. Results come back as tensors and host arrays directly (the
reference packs them into one flat vector for its remote device link).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ldso_tpu_torch import telemetry
from ldso_tpu_torch.ba.residuals import assemble
from ldso_tpu_torch.config import LdsoConfig
from ldso_tpu_torch.core.window import Window, state_delta
from ldso_tpu_torch.math import lie


def scale_vector(F: int, scales) -> np.ndarray:
    """Per-state-dimension scale factors (reference: SCALE_XI_TRANS etc.)."""
    per_frame = np.asarray(
        [scales.xi_trans] * 3 + [scales.xi_rot] * 3 + [scales.a, scales.b],
        dtype=np.float32)
    cam = np.asarray([scales.f, scales.f, scales.c, scales.c], dtype=np.float32)
    return np.concatenate([np.tile(per_frame, F), cam])


def prior_diag(frame_valid: torch.Tensor, cfg: LdsoConfig) -> torch.Tensor:
    """[D] diagonal prior: affine λ-priors per valid frame + the soft
    intrinsics prior; invalid slots get a unit diagonal."""
    dev = frame_valid.device
    per = torch.where(
        frame_valid[:, None],
        torch.tensor([0.0] * 6 + [cfg.ba.affine_prior_a, cfg.ba.affine_prior_b],
                     dtype=torch.float32, device=dev)[None, :],
        torch.ones(8, dtype=torch.float32, device=dev)[None, :])
    cam = torch.full((4,), cfg.ba.intrinsics_prior, dtype=torch.float32, device=dev)
    return torch.cat([per.reshape(-1), cam])


def prior_offset(win: Window) -> torch.Tensor:
    """[D] offset turning the diagonal prior into an ABSOLUTE-state prior
    for the affine dims (energy = ½·λ·(Δ+off)², off = x_zero[a,b])."""
    off = torch.zeros_like(win.x)
    off[:, 6:8] = torch.where(win.frame_valid[:, None], win.x_zero[:, 6:8], 0.0)
    return torch.cat([off.reshape(-1), torch.zeros(4, dtype=win.x.dtype,
                                                   device=win.x.device)])


def fix_mask(F: int, anchor_slot: int) -> np.ndarray:
    """[D] bool: state dims hard-fixed in the solve (the gauge anchor's pose)."""
    m = np.zeros(8 * F + 4, dtype=bool)
    if anchor_slot >= 0:
        m[8 * anchor_slot: 8 * anchor_slot + 6] = True
    return m


def scale_nullspace(win: Window, anchor_slot: int) -> torch.Tensor:
    """[D] the scale-gauge direction left with a fixed anchor: scaling
    about the anchor's camera center moves every other translation by
    t_i + R_i·C_anchor."""
    F = win.num_frames
    R = lie.rotation(win.T_eval)
    t = lie.translation(win.T_eval)
    slot = max(anchor_slot, 0)
    C0 = -(R[slot].T @ t[slot])
    rows = t + R @ C0                                                  # [F, 3]
    keep = win.frame_valid & (torch.arange(F, device=rows.device) != slot)
    N = torch.zeros((F, 8), dtype=win.x.dtype, device=rows.device)
    N[:, :3] = torch.where(keep[:, None], rows, 0.0)
    return torch.cat([N.reshape(-1), torch.zeros(4, dtype=N.dtype, device=N.device)])


def _fixed_scaled_solve(H_f, b_f, scale_vec, fixed):
    """dx of the damped reduced system H_f dx = -b_f: the gauge-anchor
    dims hard-fixed (identity rows/cols, zero gradient), then a dense solve
    scaled by ``scale_vec`` and Jacobi-preconditioned."""
    H_f = torch.where(fixed[:, None] | fixed[None, :], 0.0, H_f)
    H_f = H_f + torch.diag(fixed.to(H_f.dtype))
    b_f = torch.where(fixed, 0.0, b_f)
    S = scale_vec
    Hs = H_f * S[:, None] * S[None, :]
    bs = b_f * S
    pc = 1.0 / torch.sqrt(torch.diagonal(Hs) + 10.0)
    Hp = Hs * pc[:, None] * pc[None, :]
    y = torch.linalg.solve_ex(Hp, (bs * pc)[:, None])[0][:, 0]
    return -(S * pc * y)


def _solve_core(sys_H, sys_b, sys_Hxd, sys_Hdd, sys_bd, HM, bM, delta, prior_d,
                scale_vec, fixed, N_scale, lam, p_valid, prior_off=None):
    """One damped GN solve: returns (dx [D], dd [P])."""
    if prior_off is None:
        prior_off = torch.zeros_like(delta)
    # total gradient/Hessian at the current state (prior shifted by delta;
    # the diagonal prior acts on delta+off — absolute affine states)
    b = sys_b + bM + HM @ delta + prior_d * (delta + prior_off)
    H = sys_H + HM + torch.diag(prior_d)

    # Schur complement of idepths with damped H_dd
    Hdd_damped = sys_Hdd * (1.0 + lam) + 1e-10
    active = p_valid & (sys_Hdd > 1e-10)
    inv_dd = torch.where(active, 1.0 / Hdd_damped, 0.0)
    H_sc = sys_Hxd.T @ (sys_Hxd * inv_dd[:, None])
    b_sc = sys_Hxd.T @ (sys_bd * inv_dd)

    H_f = H.clone()
    torch.diagonal(H_f).mul_(1.0 + lam)
    dx = _fixed_scaled_solve(H_f - H_sc, b - b_sc, scale_vec, fixed)

    # project the scale-gauge direction out of the step
    n2 = torch.dot(N_scale, N_scale)
    coef = torch.where(n2 > 1e-8, torch.dot(N_scale, dx) / torch.clamp(n2, min=1e-8), 0.0)
    dx = torch.where(fixed, 0.0, dx - coef * N_scale)

    # backsubstitution for idepths
    dd = torch.where(active, -(sys_bd + sys_Hxd @ dx) * inv_dd, 0.0)
    return dx, dd


def apply_step(win: Window, dx, dd) -> Window:
    """Additive update in the FEJ tangent chart."""
    F = win.num_frames
    new_id = torch.clamp(win.p_idepth + dd, 1e-5, 50.0)
    return win._replace(
        x=win.x + torch.where(win.frame_valid[:, None], dx[: 8 * F].reshape(F, 8), 0.0),
        c=win.c + dx[8 * F:],
        p_idepth=torch.where(win.p_valid, new_id, win.p_idepth),
    )


class BAStats(NamedTuple):
    iterations: int           # accepted LM steps
    energy_initial: float
    energy_final: float       # photometric + prior expansion (may be < 0)
    num_residuals: int
    lam_final: float
    energy_photo: float = 0.0  # photometric Huber energy only (≥ 0)
    idepth_hessian: object = None     # np [P] idepth Hessian at the solution
    valid_pair: object = None         # np bool [P, F]
    # post-BA window snapshot (host numpy)
    poses: object = None              # np [F, 4, 4] current worldToCam (f64)
    x: object = None                  # np [F, 8]
    x_zero: object = None             # np [F, 8]
    exposure: object = None           # np [F]
    p_valid: object = None            # np bool [P] (before the junk drop)
    p_host: object = None             # np i32 [P]
    p_idepth: object = None           # np [P]
    res_mask: object = None           # np bool [P, F]
    p_uv: object = None               # np [P, 2] host-frame pixel coords
    p_color: object = None            # np [P] center-pattern intensity
    c: object = None                  # np [4] post-BA intrinsics
    junk: object = None               # np bool [P] rows retired by the BA tail
    lam_ladder: object = None         # λ after each iteration (host floats)
    energy_ladder: object = None      # the trial energy of each iteration (host floats)


@telemetry.span("ba")
def run_ba(win: Window, HM: np.ndarray, bM: np.ndarray, cfg: LdsoConfig,
           anchor_slot: int = 0) -> Tuple[Window, BAStats]:
    """Windowed-BA energy-gated LM loop (reference: FullSystem::optimize
    via ``_ba_loop_device``), then the residual-activity refresh and the
    retirement of residual-less points that fail the marginalize gates."""
    F = win.num_frames
    dev = win.x.device
    huber = cfg.ba.huber_th
    osum = cfg.ba.outlier_th_sum_component

    # loop-invariant solver inputs (FEJ quantities never move in-loop)
    prior_d = prior_diag(win.frame_valid, cfg)
    s_vec = torch.as_tensor(scale_vector(F, cfg.scales), device=dev)
    fixed = torch.as_tensor(fix_mask(F, anchor_slot), device=dev)
    N_scale = scale_nullspace(win, anchor_slot)
    p_off = prior_offset(win)
    HM_t = torch.as_tensor(HM, dtype=torch.float32, device=dev)
    bM_t = torch.as_tensor(bM, dtype=torch.float32, device=dev)

    def total_energy(photo_E, w):
        delta = state_delta(w)
        da = delta + p_off
        return (photo_E + torch.dot(delta, bM_t)
                + 0.5 * torch.dot(delta, HM_t @ delta)
                + 0.5 * torch.sum(prior_d * da * da))

    with telemetry.span("ba.assemble"):
        sys = assemble(win, huber_th=huber, outlier_sum=osum)
    E0_t = total_energy(sys.energy, win)
    with telemetry.span("wait.ba_gate"):
        E0 = float(E0_t)
    E = E0
    lam = np.float32(cfg.ba.lambda_initial)
    n_steps = 0
    ladder, trials = [], []
    for it in range(cfg.ba.max_iterations):
        with telemetry.span("ba.solve"):
            dx, dd = _solve_core(sys.H, sys.b, sys.H_xd, sys.H_dd, sys.b_d,
                                 HM_t, bM_t, state_delta(win), prior_d, s_vec, fixed,
                                 N_scale, float(lam), win.p_valid, prior_off=p_off)
        with telemetry.span("ba.apply"):
            w_try = apply_step(win, dx, cfg.scales.idepth * dd)
        with telemetry.span("ba.assemble"):
            sys_try = assemble(w_try, huber_th=huber, outlier_sum=osum)
        E_try_t = total_energy(sys_try.energy, w_try)
        step_t = torch.amax(torch.abs(dx))
        with telemetry.span("wait.ba_gate"):
            E_try = float(E_try_t)
            step = float(step_t)
        ok = bool(np.isfinite(E_try)) and E_try < E
        telemetry.count("ba.trials")
        telemetry.count("ba.accepted", int(ok))
        if ok:
            win, sys, E = w_try, sys_try, E_try
            lam = np.float32(max(lam * np.float32(0.25), np.float32(1e-7)))
            n_steps += 1
        else:
            lam = np.float32(lam * np.float32(4.0))
        ladder.append(float(lam))
        trials.append(E_try)
        if (ok and step < cfg.ba.step_break_th and it + 1 >= cfg.ba.min_iterations) \
                or lam > 1e2:
            break

    # final residual-activity refresh (reference: removeOutliers tail)
    outlier_pair = sys.e_pair > (cfg.ba.outlier_th * 8.0)
    win = win._replace(res_mask=win.res_mask & ~sys.oob_pair & ~outlier_pair)

    # retirement of points with no residual left that fail the marginalize
    # gates (idepth Hessian, relative baseline). Kept as the reference has
    # it (ROADMAP fault F1): rel_b is taken from the res_mask AFTER the
    # refresh, so a point with no residual has rel_b == 0, fold_worthy is
    # always false there, and junk == no_res.
    T_fin = win.current_pose()
    no_res = win.p_valid & (torch.sum(win.res_mask, dim=1) == 0)
    C_all = -torch.einsum("fji,fj->fi", T_fin[:, :3, :3], T_fin[:, :3, 3])
    dist = torch.linalg.norm(C_all[win.p_host.long()][:, None, :] - C_all[None, :, :],
                             dim=-1)
    rel_b = torch.amax(torch.where(win.res_mask, dist, 0.0), dim=1) * win.p_idepth
    fold_worthy = (sys.H_dd > cfg.ba.min_idepth_hessian) & (rel_b > cfg.ba.min_rel_baseline)
    junk = no_res & ~fold_worthy

    with telemetry.span("wait.ba_stats"):
        stats = BAStats(
            iterations=n_steps, energy_initial=E0, energy_final=E,
            num_residuals=int(sys.num_res), lam_final=float(lam),
            energy_photo=float(sys.energy),
            idepth_hessian=sys.H_dd.cpu().numpy(),
            valid_pair=sys.valid_pair.cpu().numpy(),
            poses=T_fin.cpu().numpy().astype(np.float64),
            x=win.x.cpu().numpy(), x_zero=win.x_zero.cpu().numpy(),
            exposure=win.exposure.cpu().numpy(),
            p_valid=win.p_valid.cpu().numpy(), p_host=win.p_host.cpu().numpy(),
            p_idepth=win.p_idepth.cpu().numpy(), res_mask=win.res_mask.cpu().numpy(),
            p_uv=win.p_uv.cpu().numpy(), p_color=win.p_color[:, 4].cpu().numpy(),
            c=win.c.cpu().numpy(), junk=junk.cpu().numpy(), lam_ladder=ladder,
            energy_ladder=trials)
    win = win._replace(p_valid=win.p_valid & ~junk,
                       res_mask=win.res_mask & ~junk[:, None])
    return win, stats
