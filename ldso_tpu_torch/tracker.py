"""Frame-to-keyframe direct image alignment (the coarse tracker).

Port of ``ldso_tpu/tracker.py``: pyramidal Levenberg-Marquardt on the
8-dof relative state [xi(6), a, b] against a semi-dense reference point
set, with the residual cutoff (``coarse_cutoff_th``) and Huber weights.

All motion hypotheses run as one batch through the two coarsest levels;
the winner refines through the finer levels. The reference vmaps a
``lax.while_loop`` over the hypotheses: each lane stops on its own
``done`` flag and is frozen afterwards while the others continue. Here
the batch dimension is written out, every update is masked with the
per-lane ``active`` flag, and the loop runs until no lane is active or
the iteration budget is spent — so the same hypothesis wins.

``_level_system`` (residuals + 8x8 normal equations for one level) is a
torch composition; it is the first candidate for a hand kernel once the
card's numbers show it binding.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ldso_tpu_torch.cameras import level_intrinsics
from ldso_tpu_torch.kernels.interp import bilinear_packed, in_bounds, pack_corners
from ldso_tpu_torch.math import lie


class TrackerRef(NamedTuple):
    """Reference keyframe data for tracking (per pyramid level)."""

    uv: Tuple[torch.Tensor, ...]       # per level [N_l, 2] pixel coords (level scale)
    idepth: Tuple[torch.Tensor, ...]   # per level [N_l]
    color: Tuple[torch.Tensor, ...]    # per level [N_l]
    valid: Tuple[torch.Tensor, ...]    # per level [N_l] bool
    exposure: torch.Tensor             # scalar
    aff_ab: torch.Tensor               # [2] reference frame's affine state


class TrackResult(NamedTuple):
    T: torch.Tensor            # [4, 4] refToNew SE3
    ab: torch.Tensor           # [2] affine (a, b) of new frame relative to ref
    rmse: torch.Tensor         # per-level residual RMSE [L]
    frac_saturated: torch.Tensor
    frac_oob: torch.Tensor
    flow: torch.Tensor         # [3] (t-only, full, r-only) RMS pixel flow


def make_tracker_ref(points_uv, points_idepth, points_color, points_valid,
                     levels: int, exposure=1.0, aff_ab=(0.0, 0.0)) -> TrackerRef:
    """Per-level reference lists from level-0 points. Coarser levels keep
    a decimated point set (N >> l, floor 256); valid points are
    compacted to the front (stable) so the truncation drops padding first."""
    dev = points_uv.device
    n = points_uv.shape[0]
    order = torch.argsort((~points_valid).to(torch.int32), stable=True)
    uvs, ids, cols, vals = [], [], [], []
    for l in range(levels):
        s = 0.5 ** l
        sel = order[:min(n, max(256, n >> l))]
        uvs.append(points_uv[sel] * s + (0.5 * s - 0.5))
        ids.append(points_idepth[sel])
        cols.append(points_color[sel])
        vals.append(points_valid[sel])
    return TrackerRef(
        uv=tuple(uvs), idepth=tuple(ids), color=tuple(cols), valid=tuple(vals),
        exposure=torch.as_tensor(exposure, dtype=torch.float32, device=dev),
        aff_ab=torch.as_tensor(aff_ab, dtype=torch.float32, device=dev),
    )


def _level_residuals(packed, uv, idepth, color, valid, T, ab, intr_l, w, h,
                     cutoff, huber_th):
    """Residuals + per-point weights for one level at K relative states.

    packed: corner-packed (I, dx, dy) level image [H, W, 12]; uv [N, 2];
    T [K, 4, 4]; ab [K, 2]. Returns per-lane [K, N] arrays."""
    fx, fy, cx, cy = intr_l[0], intr_l[1], intr_l[2], intr_l[3]
    xh = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy,
                      torch.ones_like(uv[..., 0])], dim=-1)             # [N, 3]
    R, t = T[:, :3, :3], T[:, :3, 3]
    X = torch.einsum("kij,pj->kpi", R, xh) + t[:, None, :] * idepth[None, :, None]
    z = X[..., 2]
    ok_z = z > 1e-6
    safe_z = torch.where(ok_z, z, torch.ones_like(z))
    up, vp = X[..., 0] / safe_z, X[..., 1] / safe_z
    new_id = idepth[None, :] / safe_z
    uv_new = torch.stack([fx * up + cx, fy * vp + cy], dim=-1)
    inb = in_bounds(uv_new, w, h, 2.0) & ok_z & valid[None, :]

    hit = bilinear_packed(packed, torch.where(inb[..., None], uv_new, 2.0), 3)
    r = hit[..., 0] - torch.exp(ab[:, 0:1]) * color[None, :] - ab[:, 1:2]
    abs_r = torch.abs(r)
    saturated = abs_r > cutoff
    hw = torch.where(abs_r < huber_th, 1.0, huber_th / torch.clamp(abs_r, min=1e-12))
    omega = torch.where(inb & ~saturated, hw, 0.0)
    return r, omega, hit, up, vp, new_id, inb, saturated


def _level_system(packed, uv, idepth, color, valid, T, ab, intr_l, w, h,
                  cutoff, huber_th):
    """Batched 8x8 GN systems for one level: H [K,8,8], b [K,8], E [K],
    n_ok, n_in, n_sat [K] (reference: calcRes + calcGSSSE)."""
    fx, fy = intr_l[0], intr_l[1]
    r, omega, hit, up, vp, new_id, inb, sat = _level_residuals(
        packed, uv, idepth, color, valid, T, ab, intr_l, w, h, cutoff, huber_th)
    gx, gy = hit[..., 1:2], hit[..., 2:3]
    zeros = torch.zeros_like(up)
    Jp_u = torch.stack([new_id * fx, zeros, -new_id * up * fx,
                        -up * vp * fx, (1 + up * up) * fx, -vp * fx], dim=-1)
    Jp_v = torch.stack([zeros, new_id * fy, -new_id * vp * fy,
                        -(1 + vp * vp) * fy, up * vp * fy, up * fy], dim=-1)
    J_pose = gx * Jp_u + gy * Jp_v                                    # [K, N, 6]
    J_a = -torch.exp(ab[:, 0:1]) * color[None, :]                       # [K, N]
    J = torch.cat([J_pose, J_a[..., None], -torch.ones_like(J_a)[..., None]], dim=-1)
    Jw = J * omega[..., None]
    H = Jw.transpose(1, 2) @ J                                         # [K, 8, 8]
    b = torch.einsum("kpi,kp->ki", Jw, r)
    E = torch.sum(omega * r * r, dim=-1)
    n_ok = torch.sum(omega > 0, dim=-1)
    n_in = torch.sum(inb, dim=-1)
    n_sat = torch.sum(sat & inb, dim=-1)
    return H, b, E, n_ok, n_in, n_sat


def track_level(img3, uv, idepth, color, valid, T0, ab0, intr_l,
                w: int, h: int, iters: int, cutoff: float, huber_th: float,
                lam0: float = 0.01, lam_success: float = 0.5,
                lam_fail: float = 4.0, step_eps: float = 1e-6):
    """LM at one pyramid level for K lanes (T0 [K,4,4], ab0 [K,2]).

    One system evaluation per iteration: the accepted state's system is
    carried, a rejected step reuses it with a larger λ. A lane is done on
    an accepted step with max|step| < step_eps, or once λ > 1e3; done
    lanes are frozen. Returns (T, ab, rmse, n_ok, n_in, n_sat), per lane."""
    packed = pack_corners(img3)
    dev, dt = T0.device, T0.dtype
    K = T0.shape[0]

    def gn_system(T, ab):
        return _level_system(packed, uv, idepth, color, valid, T, ab,
                             intr_l, w, h, cutoff, huber_th)

    T, ab = T0, ab0.to(dt)
    sysc = gn_system(T, ab)
    lam = torch.full((K,), lam0, dtype=dt, device=dev)
    done = torch.zeros(K, dtype=torch.bool, device=dev)
    eye8 = torch.eye(8, dtype=dt, device=dev)
    for _ in range(iters):
        active = ~done
        if not bool(active.any()):
            break
        H, b, E, n_ok, _, _ = sysc
        n_safe = torch.clamp(n_ok, min=1)
        trace = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        Hd = H.clone()
        torch.diagonal(Hd, dim1=-2, dim2=-1).mul_((1.0 + lam)[:, None])
        Hd = Hd + 1e-4 * eye8 * torch.clamp(trace / 8.0, min=1e-6)[:, None, None]
        step = -torch.linalg.solve_ex(Hd, b[..., None])[0][..., 0]
        T_new = lie.se3_mul(lie.se3_exp(step[:, :6]), T)
        ab_new = ab + step[:, 6:8]
        sys2 = gn_system(T_new, ab_new)
        accept = (sys2[2] / torch.clamp(sys2[3], min=1)) < (E / n_safe)
        upd = accept & active
        T = torch.where(upd[:, None, None], T_new, T)
        ab = torch.where(upd[:, None], ab_new, ab)
        sysc = tuple(torch.where(upd.view((K,) + (1,) * (a.ndim - 1)), b_, a)
                     for a, b_ in zip(sysc, sys2))
        lam_next = torch.where(accept, torch.clamp(lam * lam_success, min=1e-5),
                               lam * lam_fail)
        done_next = (accept & (torch.amax(torch.abs(step), dim=-1) < step_eps)) \
            | (lam_next > 1e3)
        lam = torch.where(active, lam_next, lam)
        done = torch.where(active, done_next, done)
    H, b, E, n_ok, n_in, n_sat = sysc
    rmse = torch.sqrt(E / torch.clamp(n_ok, min=1))
    return T, ab, rmse, n_ok, n_in, n_sat


def track_frame(pyr_new, ref: TrackerRef, T_inits, ab_init, intr, cfg,
                new_exposure: float = 1.0) -> TrackResult:
    """Full pyramidal track: batched hypotheses at the two coarsest levels
    (at most 12 LM iterations), the winner refined to level 0."""
    levels = len(pyr_new)
    tcfg = cfg.tracker
    iters = list(tcfg.max_iterations) + [50] * levels
    K = T_inits.shape[0]

    def run(l, T, ab, n_iter):
        h, w = pyr_new[l].shape[0], pyr_new[l].shape[1]
        return track_level(
            pyr_new[l], ref.uv[l], ref.idepth[l], ref.color[l], ref.valid[l],
            T, ab, level_intrinsics(intr, l), w, h, n_iter,
            float(tcfg.coarse_cutoff_th * (2.0 ** l)), float(tcfg.huber_th),
            lam0=float(tcfg.lambda_initial),
            lam_success=float(tcfg.lambda_success),
            lam_fail=float(tcfg.lambda_fail),
            step_eps=float(tcfg.step_eps))

    T_cand, ab_cand = T_inits, ab_init.expand(K, 2)
    rmses = None
    for l in range(levels - 1, max(levels - 3, 0), -1):
        T_cand, ab_cand, rmses, _, _, _ = run(l, T_cand, ab_cand, min(int(iters[l]), 12))
    best = torch.argmin(torch.where(torch.isfinite(rmses), rmses,
                                    torch.full_like(rmses, float("inf"))))
    T, ab = T_cand[best][None], ab_cand[best][None]

    dev = T_inits.device
    rmse_per_level = [torch.zeros((), dtype=torch.float32, device=dev)] * levels
    n_in = n_sat = torch.zeros((), dtype=torch.int64, device=dev)
    for l in range(max(levels - 3, 0), -1, -1):
        T, ab, rmse, _, n_in, n_sat = run(l, T, ab, int(iters[l]))
        rmse_per_level[l] = rmse[0]
        n_in, n_sat = n_in[0], n_sat[0]
    T, ab = T[0], ab[0]

    flow = _flow_indicators(ref, T, intr)
    frac_sat = n_sat / torch.clamp(n_in, min=1)
    frac_oob = 1.0 - n_in / torch.clamp(torch.sum(ref.valid[0]), min=1)
    return TrackResult(T=T, ab=ab, rmse=torch.stack(rmse_per_level),
                       frac_saturated=frac_sat, frac_oob=frac_oob, flow=flow)


def _flow_indicators(ref: TrackerRef, T, intr):
    """RMS pixel displacement under (t-only, full, R-only) motion — the
    keyframe-decision inputs."""
    uv, idep, valid = ref.uv[0], ref.idepth[0], ref.valid[0]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    xh = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy,
                      torch.ones_like(uv[..., 0])], dim=-1)

    def proj(R, t):
        X = xh @ R.T + t[None, :] * idep[:, None]
        z = torch.clamp(X[..., 2], min=1e-6)
        return torch.stack([fx * X[..., 0] / z + cx, fy * X[..., 1] / z + cy], dim=-1)

    R, t = T[:3, :3], T[:3, 3]
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    wv = valid.to(uv.dtype)
    n = torch.clamp(torch.sum(wv), min=1.0)

    def rms(d):
        return torch.sqrt(torch.sum(wv * torch.sum(d * d, dim=-1)) / n)

    return torch.stack([rms(proj(eye, t) - uv), rms(proj(R, t) - uv),
                        rms(proj(R, torch.zeros_like(t)) - uv)])


def motion_hypotheses(T_const_vel, num: int = 27) -> torch.Tensor:
    """[K, 4, 4] initial guesses: constant velocity, half, double, zero,
    plus small-rotation perturbations of the constant-velocity guess."""
    xi = lie.se3_log(T_const_vel.to(torch.float32))
    cands = [xi, 0.5 * xi, 2.0 * xi, torch.zeros_like(xi)]
    rot = 0.02
    deltas = []
    for ax in range(3):
        for sgn in (1.0, -1.0):
            d = torch.zeros_like(xi)
            d[3 + ax] = sgn * rot
            deltas.append(d)
    for ax1 in range(3):
        for ax2 in range(ax1 + 1, 3):
            for s1 in (1.0, -1.0):
                for s2 in (1.0, -1.0):
                    d = torch.zeros_like(xi)
                    d[3 + ax1] = s1 * rot
                    d[3 + ax2] = s2 * rot
                    deltas.append(d)
    cands += [xi + d for d in deltas]
    cands = cands[:num]
    while len(cands) < num:
        cands.append(xi)
    return lie.se3_exp(torch.stack(cands))
