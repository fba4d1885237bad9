"""Frame-to-keyframe direct image alignment (the coarse tracker).

Port of ``ldso_tpu/tracker.py``: pyramidal Levenberg-Marquardt on the
8-dof relative state [xi(6), a, b] against a semi-dense reference point
set, with the residual cutoff (``coarse_cutoff_th``) and Huber weights.

All motion hypotheses run as one batch through the two coarsest levels;
the winner refines through the finer levels. The reference vmaps a
``lax.while_loop`` over the hypotheses: each lane stops on its own
``done`` flag and is frozen afterwards while the others continue.

``track_level`` (one level) and ``track_frame``'s level chain
(``_run_levels``) dispatch on the device of their tensors. On the card the
CUDA kernel ``csrc/track_level.cu`` (``kernels/track_level.py``) runs a
table of levels, every lane's whole loop, in ONE launch: ``track_frame``
is two launches (the coarse levels for every lane; then the winner, picked
on the device, through the fine levels) and no host sync. A CPU tensor
takes ``track_level_torch``, the plain version: the batch dimension
written out, every update masked with the per-lane ``active`` flag, and a
host loop that runs until no lane is active or the iteration budget is
spent, so the same hypothesis wins. There is no fallback between the two.

The hypotheses come from ``predict_hypotheses`` the same way: on the card
one launch of ``csrc/predict.cu`` (``kernels/predict.py``) makes the
constant-velocity pose and every hypothesis, on CPU tensors the plain
chain ``predict_hypotheses_torch`` (``motion_hypotheses``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

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
    """LM at one pyramid level for K lanes (T0 [K,4,4], ab0 [K,2]):
    ``track_level_torch`` for CPU tensors, the CUDA kernel (one launch)
    for CUDA tensors. Returns (T, ab, rmse, n_ok, n_in, n_sat), per lane.
    The one-level entry, for tests and scripts: ``track_frame`` runs its
    levels through ``_run_levels``."""
    args = (img3, uv, idepth, color, valid, T0, ab0.to(T0.dtype), intr_l)
    if img3.device.type == "cpu":
        return track_level_torch(*args, w, h, iters, cutoff, huber_th, lam0,
                                 lam_success, lam_fail, step_eps)
    if img3.device.type == "cuda":
        from ldso_tpu_torch.kernels.track_level import track_level_cuda

        return track_level_cuda(*(a.contiguous() for a in args), w, h, iters, cutoff,
                                huber_th, lam0, lam_success, lam_fail, step_eps)[:6]
    raise ValueError(f"no tracker level for device {img3.device}")


def track_level_torch(img3, uv, idepth, color, valid, T0, ab0, intr_l,
                      w: int, h: int, iters: int, cutoff: float, huber_th: float,
                      lam0: float = 0.01, lam_success: float = 0.5,
                      lam_fail: float = 4.0, step_eps: float = 1e-6):
    """LM at one pyramid level for K lanes (T0 [K,4,4], ab0 [K,2]), the
    plain torch version of the kernel.

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


class LevelPlan(NamedTuple):
    """One level of a tracked frame's chain, as ``track_frame`` runs it."""

    level: int
    h: int
    w: int
    n: int                     # reference points at the level
    cap: int                   # iteration cap
    cutoff: float              # residual cutoff
    intr_row: int              # row of ``_level_intrinsics_all``


def level_plan(pyr_new, ref: TrackerRef, tcfg) -> tuple:
    """(coarse, fine): the levels of a tracked frame in chain order. The two
    coarsest run every hypothesis, at most 12 LM iterations; the finer ones
    refine the winner, at the level's ``max_iterations``."""
    levels = len(pyr_new)
    iters = list(tcfg.max_iterations) + [50] * levels

    def plan(l, cap):
        return LevelPlan(l, int(pyr_new[l].shape[0]), int(pyr_new[l].shape[1]),
                         int(ref.uv[l].shape[0]), cap,
                         float(tcfg.coarse_cutoff_th * (2.0 ** l)), l)

    return (tuple(plan(l, min(int(iters[l]), 12))
                  for l in range(levels - 1, max(levels - 3, 0), -1)),
            tuple(plan(l, int(iters[l])) for l in range(max(levels - 3, 0), -1, -1)))


def track_frame(pyr_new, ref: TrackerRef, T_inits, ab_init, intr, cfg,
                new_exposure: float = 1.0) -> TrackResult:
    """Full pyramidal track: batched hypotheses at the two coarsest levels
    (at most 12 LM iterations), the winner refined to level 0."""
    plan = level_plan(pyr_new, ref, cfg.tracker)
    intr_levels = _level_intrinsics_all(intr, len(pyr_new))
    T, ab, rmse, n_in, n_sat = _run_levels(pyr_new, ref, T_inits, ab_init, intr_levels,
                                           plan, cfg.tracker)
    flow = _flow_indicators(ref, T, intr)
    frac_sat = n_sat / torch.clamp(n_in, min=1)
    frac_oob = 1.0 - n_in / torch.clamp(torch.sum(ref.valid[0]), min=1)
    return TrackResult(T=T, ab=ab, rmse=rmse, frac_saturated=frac_sat,
                       frac_oob=frac_oob, flow=flow)


def _run_levels(pyr, ref, T_inits, ab_init, intr_levels, plan, tcfg):
    """The level chain of ``track_frame``: the kernel's two launches for
    CUDA tensors, the plain version for CPU tensors. Returns level 0's
    (T [4, 4], ab [2]), the rmse of each level [L] (0 at the coarse
    levels) and level 0's n_in, n_sat."""
    if T_inits.device.type == "cuda":
        return _run_levels_kernel(pyr, ref, T_inits, ab_init, intr_levels, plan, tcfg)
    if T_inits.device.type == "cpu":
        return _run_levels_plain(pyr, ref, T_inits, ab_init, intr_levels, plan, tcfg)
    raise ValueError(f"no tracker for device {T_inits.device}")


def _lm_args(tcfg) -> dict:
    return dict(lam0=float(tcfg.lambda_initial), lam_success=float(tcfg.lambda_success),
                lam_fail=float(tcfg.lambda_fail), step_eps=float(tcfg.step_eps))


def _run_levels_kernel(pyr, ref, T_inits, ab_init, intr_levels, plan, tcfg):
    from ldso_tpu_torch.kernels.track_level import track_levels_cuda

    out = track_levels_cuda(pyr, ref, plan, intr_levels, T_inits.contiguous(),
                            ab_init.reshape(2).to(T_inits.dtype).contiguous(),
                            float(tcfg.huber_th), **_lm_args(tcfg))
    n_fine = len(plan[1])
    rmse = torch.cat([out.rmse[:n_fine, 0], out.rmse.new_zeros(len(pyr) - n_fine)])
    return out.T[0, 0], out.ab[0, 0], rmse, out.n_in[0, 0], out.n_sat[0, 0]


def _run_levels_plain(pyr, ref, T_inits, ab_init, intr_levels, plan, tcfg):
    coarse, fine = plan
    K = T_inits.shape[0]

    def run(p, T, ab):
        l = p.level
        return track_level_torch(
            pyr[l], ref.uv[l], ref.idepth[l], ref.color[l], ref.valid[l], T, ab.to(T.dtype),
            intr_levels[p.intr_row], p.w, p.h, p.cap, p.cutoff, float(tcfg.huber_th),
            **_lm_args(tcfg))

    T_cand, ab_cand = T_inits, ab_init.expand(K, 2)
    rmses = None
    for p in coarse:
        T_cand, ab_cand, rmses, _, _, _ = run(p, T_cand, ab_cand)
    inf = float("inf")
    best = torch.argmin(torch.nan_to_num(rmses, nan=inf, posinf=inf, neginf=inf))[None]
    # the winner is picked on the device: nothing is read back
    T, ab = T_cand.index_select(0, best), ab_cand.index_select(0, best)

    rmse_per_level = [torch.zeros((), dtype=torch.float32, device=T_inits.device)] * len(pyr)
    for p in fine:
        T, ab, rmse, _, n_in, n_sat = run(p, T, ab)
        rmse_per_level[p.level] = rmse[0]
        n_in, n_sat = n_in[0], n_sat[0]
    return T[0], ab[0], torch.stack(rmse_per_level), n_in, n_sat


def _level_intrinsics_all(intr, levels: int):
    """[levels, 4]: ``cameras.level_intrinsics(intr, l)`` for every level
    at once, in a few launches and with no copy from the host; the scales
    2^-l are products of halves, so exact."""
    s = torch.full((levels,), 0.5, dtype=intr.dtype, device=intr.device).cumprod(0) * 2.0
    half = intr.new_zeros(4)
    half[2:] = 0.5                  # fx·s, fy·s, (cx + 0.5)·s − 0.5, (cy + 0.5)·s − 0.5
    return (intr + half) * s[:, None] - half


def _flow_indicators(ref: TrackerRef, T, intr):
    """RMS pixel displacement under (t-only, full, R-only) motion — the
    keyframe-decision inputs. The three motions are projected as one
    batch: X_t = xh + t·idepth, X_full = R·xh + t·idepth, X_r = R·xh."""
    uv, idep, valid = ref.uv[0], ref.idepth[0], ref.valid[0]
    f, c = intr[0:2], intr[2:4]
    xh = torch.cat([(uv - c) / f, torch.ones_like(uv[..., :1])], dim=-1)   # [N, 3]
    R, t = T[:3, :3], T[:3, 3]
    Rx = xh @ R.T
    tz = t[None, :] * idep[:, None]
    X = torch.stack([xh + tz, Rx + tz, Rx])                                # [3, N, 3]
    z = torch.clamp(X[..., 2:3], min=1e-6)
    d = (f * X[..., :2]) / z + c - uv
    wv = valid.to(uv.dtype)
    n = torch.clamp(torch.sum(wv), min=1.0)
    return torch.sqrt(torch.sum(wv * torch.sum(d * d, dim=-1), dim=-1) / n)


_HYP_DELTAS: dict = {}


def _hypothesis_deltas(dev) -> torch.Tensor:
    """The small-rotation offsets of hypotheses 4.. [18, 6] float32: each
    axis at +-0.02 rad, then each pair of axes at (+-0.02, +-0.02); made
    once per device (built on the card one entry at a time, they took some
    70 launches a frame)."""
    key = str(dev)
    deltas = _HYP_DELTAS.get(key)
    if deltas is None:
        rot, rows = 0.02, []
        for ax in range(3):
            for sgn in (1.0, -1.0):
                rows.append([sgn * rot if i == 3 + ax else 0.0 for i in range(6)])
        for ax1 in range(3):
            for ax2 in range(ax1 + 1, 3):
                for s1 in (1.0, -1.0):
                    for s2 in (1.0, -1.0):
                        rows.append([s1 * rot if i == 3 + ax1 else s2 * rot if i == 3 + ax2
                                     else 0.0 for i in range(6)])
        deltas = _HYP_DELTAS.setdefault(
            key, torch.tensor(rows, dtype=torch.float32, device=dev))
    return deltas


def predict_hypotheses(T_last, T_prelast, num: int) -> torch.Tensor:
    """[num, 4, 4] initial guesses around the constant-velocity prediction
    (T_last T_prelast^-1) T_last of the last two refToNew poses [4, 4]: the
    plain chain ``predict_hypotheses_torch`` for CPU tensors, the CUDA
    kernel (one launch, ``kernels/predict.predict_hypotheses_cuda``, the
    chain's bits) for CUDA tensors. There is no fallback between the two."""
    if T_last.device.type == "cpu":
        return predict_hypotheses_torch(T_last, T_prelast, num)
    if T_last.device.type == "cuda":
        from ldso_tpu_torch.kernels.predict import predict_hypotheses_cuda

        return predict_hypotheses_cuda(T_last, T_prelast, num)
    raise ValueError(f"no motion prediction for device {T_last.device}")


def predict_hypotheses_torch(T_last, T_prelast, num: int) -> torch.Tensor:
    """The plain version of the prediction kernel, and its yardstick on the
    card: ``motion_hypotheses`` of the constant-velocity pose."""
    T_cv = lie.se3_mul(lie.se3_mul(T_last, lie.se3_inverse(T_prelast)), T_last)
    return motion_hypotheses(T_cv, num)


def motion_hypotheses(T_const_vel, num: int = 27) -> torch.Tensor:
    """[K, 4, 4] initial guesses: constant velocity, half, double, zero,
    plus small-rotation perturbations of the constant-velocity guess (the
    list padded with the constant-velocity guess, or cut, to ``num``)."""
    xi = lie.se3_log(T_const_vel.to(torch.float32))
    deltas = _hypothesis_deltas(xi.device)
    parts = [torch.stack([xi, 0.5 * xi, 2.0 * xi, torch.zeros_like(xi)]), xi + deltas]
    if num > 4 + deltas.shape[0]:
        parts.append(xi.expand(num - 4 - deltas.shape[0], 6))
    return lie.se3_exp(torch.cat(parts)[:num])
