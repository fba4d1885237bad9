"""The comparison that decides ``correct``.

During the window the harness keeps a sample, drawn from the seed, of the
program's calls of the per-frame program (``frame_step.fused_step``: the
pyramid K1, the tracker K2, the trace K3) and of the keyframe path
(``lifecycle.kf_activate``: activation K5; inside ``ba.solve.run_ba`` the
linearization ``assemble`` (K4), the damped solve ``_solve_core`` and the
step ``apply_step``; the whole ``run_ba``, judged by the objective
its state reaches; ``ba.marginal.marginalize_points`` and
``marginalize_frame``: the folds of points and of a keyframe into the
prior; the seeding program ``system._seed_program`` (corners, gradient
pixels, their pattern samples) and ``lifecycle.compute_seed_patch``; the
tracker reference's ``system._project_points_to_slot`` and
``tracker.make_tracker_ref``), and during set-up of the bootstrap's
``init2f.init_level`` (K6), each with its arguments and result.
After the window the plain reference (``ldso_bench.reference``) runs each
kept call again from the same arguments, the program's own state at that
call, and each number below measures how far the program's result lies
from the reference's. ``control`` runs the reference in the program's
place with every floating input, and the pyramid it builds, stored in
bfloat16 (its arithmetic in float32): the precision step below the
configuration's float32. The seeding program's inputs are exact in
bfloat16, so its control computes in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from ldso_bench.harness.spans import clone
from ldso_bench.reference import bank as r_bank
from ldso_bench.reference import frame_step as r_step
from ldso_bench.reference import init2f as r_init
from ldso_bench.reference import lifecycle as r_life
from ldso_bench.reference import marginal as r_marg
from ldso_bench.reference import residuals as r_res
from ldso_bench.reference import seed as r_seed
from ldso_bench.reference import solve as r_solve
from ldso_bench.reference import tracker as r_tracker
from ldso_bench.reference import window as r_window


def _bf16(x):
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    if isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
        return torch.as_tensor(x).to(torch.bfloat16).to(torch.float64).numpy().astype(x.dtype)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_bf16(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_bf16(v) for v in x)
    if isinstance(x, dict):
        return {k: _bf16(v) for k, v in x.items()}
    return x


def _in_bf16(x):
    """Floating tensors of ``x`` (tuples, lists) cast to bfloat16 and kept
    there, so that the arithmetic on them runs in bfloat16."""
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(torch.bfloat16)
    if isinstance(x, (tuple, list)):
        return type(x)(_in_bf16(v) for v in x)
    return x


def _ref_types(name: str, args: tuple) -> tuple:
    """The kept arguments with the program's state types swapped for the
    reference's NamedTuples (same fields)."""
    a = list(args)
    if name == "step":
        a[1] = r_tracker.TrackerRef(*a[1])
        a[5] = r_bank.Bank(*a[5])
    elif name == "activate":
        a[0] = r_window.Window(*a[0])
        a[1] = r_bank.Bank(*a[1])
    elif name in ("marg", "k4", "apply", "ba", "project"):
        a[0] = r_window.Window(*a[0])
    elif name == "patch":
        a[0] = r_bank.Bank(*a[0])
    return tuple(a)


class _Bf16Pyramid:
    """While entered, the reference's fused step stores its pyramid in bfloat16."""

    def __enter__(self):
        self.orig = r_step.build_pyramid

        def build(img, levels):
            pyr, gsq = self.orig(img, levels)
            return [_bf16(p) for p in pyr], [_bf16(g) for g in gsq]

        r_step.build_pyramid = build

    def __exit__(self, *exc):
        r_step.build_pyramid = self.orig


FUNCS = {"step": r_step.fused_step, "k4": r_res.assemble, "solve": r_solve._solve_core,
         "apply": r_solve.apply_step, "activate": r_life.kf_activate,
         "marg": r_marg.marginalize_points, "ba": r_solve.run_ba,
         "margf": r_marg.marginalize_frame, "seed": r_seed.seed_program,
         "patch": r_life.compute_seed_patch, "project": r_seed.project_points_to_slot,
         "tref": r_tracker.make_tracker_ref, "init": r_init.init_level}


def replay(name: str, rec: dict, control: bool = False):
    args, kw = _ref_types(name, clone(rec["args"])), rec["kw"]
    if control:
        if name == "seed":
            # the seed program's inputs (uint8 grey levels and their half
            # differences) are exact in bfloat16: its arithmetic runs there
            return FUNCS[name](*_in_bf16(args), **kw)
        args, kw = _bf16(args), _bf16(kw)
        if name == "step":
            with _Bf16Pyramid():
                return FUNCS[name](*args, **kw)
    return FUNCS[name](*args, **kw)


def _pose_gap(Ta, Tb) -> tuple:
    """(rotation gap in rad, |ta - tb|) of [..., 4, 4] poses: the rotation
    gap is |Ra - Rb|_F / sqrt(2), the angle of Ra Rb^T to second order
    (an arccos of its trace reads float32 rounding as ~1e-3 rad)."""
    Ta, Tb = torch.as_tensor(Ta, dtype=torch.float64), torch.as_tensor(Tb, dtype=torch.float64)
    rot = torch.linalg.norm(Ta[..., :3, :3] - Tb[..., :3, :3], dim=(-2, -1)) / 2 ** 0.5
    return rot, torch.linalg.norm(Ta[..., :3, 3] - Tb[..., :3, 3], dim=-1)


def _f(x) -> float:
    return float(torch.as_tensor(x).max()) if torch.as_tensor(x).numel() else 0.0


def coarse_winner(levels):
    """The tracker kernel's coarse stage's winner (T [4, 4], ab [2]) in the
    latest ``track_levels_cuda`` call (``levels``, a ``spans.Last``): the
    pose the fine launch started from; None where the kernel did not run."""
    if levels.out is None:
        return None
    coarse = levels.args[2][0]
    last, out = coarse[-1].level, levels.out
    best = out.best.long()
    return out.T[last].index_select(0, best)[0], out.ab[last].index_select(0, best)[0]


def _track_energy(pyr, ref, T, ab, intr, cfg, level: int = 0) -> torch.Tensor:
    """The tracker's objective at each pose of T [K, 4, 4] (or one [4, 4])
    with ab on pyramid level ``level``, by the reference: the
    Huber-weighted squared residual of the reference keyframe's points in
    the new frame over the points that count (omega > 0); [K] float64."""
    img = pyr[level]
    h, w = img.shape[0], img.shape[1]
    intr_l = r_tracker._level_intrinsics_all(intr, len(pyr))[level]
    T, ab = T.reshape(-1, 4, 4).float(), ab.reshape(-1, 2).float()
    _, _, E, n_ok, _, _ = r_tracker._level_system(
        r_tracker.pack_corners(img), ref.uv[level], ref.idepth[level], ref.color[level],
        ref.valid[level], T, ab, intr_l, w, h,
        float(cfg.tracker.coarse_cutoff_th * 2.0 ** level), float(cfg.tracker.huber_th))
    return (E.double() / torch.clamp(n_ok, min=1).double()).cpu()


def _fine_from(pyr, ref, T, ab, intr, cfg):
    """The reference's fine stage from one coarse winner (T, ab)."""
    plan = r_tracker.level_plan(pyr, ref, cfg.tracker)
    intr_levels = r_tracker._level_intrinsics_all(intr, len(pyr))
    T, ab = T.reshape(1, 4, 4).float(), ab.reshape(1, 2).float()
    for p in plan[1]:
        l = p.level
        T, ab, _, _, _, _ = r_tracker.track_level_torch(
            pyr[l], ref.uv[l], ref.idepth[l], ref.color[l], ref.valid[l], T, ab,
            intr_levels[p.intr_row], p.w, p.h, p.cap, p.cutoff, float(cfg.tracker.huber_th),
            **r_tracker._lm_args(cfg.tracker))
    return T[0], ab[0]


def step_numbers(prog, ref, args, winner=None, ref_lanes=None) -> dict:
    """A fused step. ``pyramid_gap``: the pyramid's largest difference in
    grey levels (every level's I, dx, dy). The tracker, followed from the
    program's own state where its coarse stage ends (the winner of the
    hypotheses, ``winner``; float32 LM lanes part at accept ties, and the
    hypotheses' coarse energies lie within tenths of a percent, so the two
    may pick different winners that end on different sides of a flat
    valley): ``track_coarse_gap``, how far the program's winner lies above
    the reference's best hypothesis on the last coarse level's objective;
    ``track_energy_gap``, how far the program's tracked pose and affine lie
    above both of the reference's answers on the level-0 objective: its own
    whole chain, and its fine stage from the program's winner (a fine
    level's LM parts at accept ties too, and two such runs of the
    reference end up to ~5% apart); both relative, and by the objective,
    not the pose. Without a winner (the plain path) the reference's whole
    chain alone. The
    pose's and affine's gaps to the reference's own chain are printed.
    ``trace_rows_parted``: the share of the bank's live rows whose trace
    result differs from the reference's trace at the program's own
    tracked pose and affine (valid, status, or an inverse-depth bound by
    more than 1e-3 of its size)."""
    img, tref, T_last, T_prelast, ab0, bank, T_eval, x, expo_all, T_ref_cw, intr, \
        new_expo, cfg = args
    pyr = max(_f((p.float() - r.float()).abs()) for p, r in zip(prog.pyr, ref.pyr))
    rot, tr = _pose_gap(prog.T, ref.T)
    dp, dr = prog.diag, ref.diag
    ab_p, ab_r = dp[9:11], dr[9:11]
    coarse_gap = 0.0
    e_refs = [float(_track_energy(ref.pyr, tref, ref.T, ab_r, intr, cfg)[0])]
    if winner is not None:
        last = r_tracker.level_plan(ref.pyr, tref, cfg.tracker)[0][-1].level
        e_w = float(_track_energy(ref.pyr, tref, winner[0], winner[1], intr, cfg, last)[0])
        e_lanes = _track_energy(ref.pyr, tref, ref_lanes[0], ref_lanes[1], intr, cfg, last)
        e_best = float(e_lanes.min())
        coarse_gap = max(0.0, (e_w - e_best) / max(e_best, 1e-12))
        T_f, ab_f = _fine_from(ref.pyr, tref, winner[0], winner[1], intr, cfg)
        e_refs.append(float(_track_energy(ref.pyr, tref, T_f, ab_f, intr, cfg)[0]))
    e_p = float(_track_energy(ref.pyr, tref, prog.T, ab_p, intr, cfg)[0])
    # the keyframe vote at the program's own pose and relative affine
    tc = cfg.tracker
    flow = r_tracker._flow_indicators(tref, prog.T.float(), intr)
    norm = 1120.0 / (ref.pyr[0].shape[0] + ref.pyr[0].shape[1])
    delta_r = tc.kf_global_weight * norm * (
        tc.max_shift_weight_t * flow[0] + tc.max_shift_weight_r * flow[2]
        + tc.max_shift_weight_rt * flow[1]) + tc.max_affine_weight * torch.abs(ab_p[0])
    e_r = max(e_refs)
    T_new_cw = r_step.lie.se3_mul(prog.T.float(), T_ref_cw)
    br = r_step._trace_core(ref.pyr[0], bank, T_eval, x, expo_all, T_new_cw, dp[7:9].float(),
                            new_expo, intr, cfg)
    bp = prog.bank

    def rel(a, b):
        both = torch.isfinite(a) & torch.isfinite(b)
        d = torch.where(both, (a - b).abs() / torch.clamp(b.abs(), min=1e-3),
                        torch.zeros_like(a))
        return (d > 1e-3) | (torch.isfinite(a) != torch.isfinite(b))

    rows = (bp.valid != br.valid) | (br.valid & ((bp.last_status != br.last_status)
                                                 | rel(bp.idepth_min, br.idepth_min)
                                                 | rel(bp.idepth_max, br.idepth_max)))
    live = int((br.valid | bp.valid).sum())
    return dict(pyramid_gap=pyr, track_coarse_gap=coarse_gap,
                track_energy_gap=max(0.0, (e_p - e_r) / max(e_r, 1e-12)),
                track_rot_gap=float(rot), track_t_gap=float(tr),
                track_a_gap=abs(float(ab_p[0] - ab_r[0])), track_b_gap=abs(float(ab_p[1] - ab_r[1])),
                trace_rows_parted=float(rows.sum()) / max(live, 1),
                kf_delta_gap=abs(float(dp[6]) - float(delta_r)))


def _rel(p, r) -> float:
    """|p - r| / |r| in the Frobenius (or absolute) norm, in float64."""
    p, r = torch.as_tensor(p).double(), torch.as_tensor(r).double()
    return float(torch.linalg.norm(p - r) / torch.clamp(torch.linalg.norm(r), min=1e-30))


def k4_numbers(prog, ref) -> dict:
    """A linearization of the BA (``assemble`` inside ``run_ba``, the K4
    kernel on the card) against the reference's of the same window:
    ``k4_system_gap``, the largest relative gap of H, b, H_xd, H_dd and b_d
    (norms over the whole array); ``k4_energy_gap``, the energy's."""
    gaps = [_rel(getattr(prog, f), getattr(ref, f)) for f in ("H", "b", "H_xd", "H_dd", "b_d")]
    return dict(k4_system_gap=max(gaps), k4_energy_gap=_rel(prog.energy, ref.energy))


def solve_numbers(prog, ref) -> dict:
    """A damped solve of the BA (``_solve_core``: the Schur complement, the
    dense solve, the gauge projection, the back substitution) against the
    reference's on the same system: ``ba_solve_gap``, the larger relative
    gap of the step's state part dx and inverse-depth part dd."""
    return dict(ba_solve_gap=max(_rel(prog[0], ref[0]), _rel(prog[1], ref[1])))


def apply_numbers(prog, ref) -> dict:
    """A step applied (``apply_step``) against the reference's on the same
    window and step: ``ba_step_gap``, the largest relative gap of the
    window's state x, intrinsics c and inverse depths."""
    return dict(ba_step_gap=max(_rel(prog.x, ref.x), _rel(prog.c, ref.c),
                                _rel(prog.p_idepth, ref.p_idepth)))


def act_numbers(prog, ref) -> dict:
    """A ``kf_activate``: the share of point rows whose activation differs
    (valid, host), and the 95th percentile of the activated points'
    relative inverse-depth gap."""
    wp, wr = prog[0], ref[0]
    rows = (wp.p_valid != wr.p_valid) | (wr.p_valid & (wp.p_host != wr.p_host))
    both = wp.p_valid & wr.p_valid
    d = ((wp.p_idepth - wr.p_idepth).abs() / torch.clamp(wr.p_idepth.abs(), min=1e-6))[both]
    return dict(act_rows_parted=float(rows.sum()) / max(int(wr.p_valid.sum()), 1),
                act_idepth_p95=float(torch.quantile(d.double(), 0.95)) if d.numel() else 0.0)


def marg_numbers(prog, ref) -> dict:
    """A ``marginalize_points``: the prior's relative Frobenius gap (HM, bM)."""
    HMp, bMp = prog
    HMr, bMr = ref
    return dict(marg_H_gap=float(np.linalg.norm(HMp - HMr) / max(np.linalg.norm(HMr), 1e-30)),
                marg_b_gap=float(np.linalg.norm(bMp - bMr) / max(np.linalg.norm(bMr), 1e-30)))


def ba_numbers(prog, ref, args) -> dict:
    """A whole ``run_ba`` (the energy-gated LM ladder: its iterations,
    damping and accepts) against the reference's own from the same window
    and prior: ``ba_energy_gap``, how far the objective at the program's
    final state (x, c, inverse depths, read by the reference) lies above
    the reference's final objective, over its photometric part. By the
    objective, not the state: two float32 ladders part at accept ties and
    end on the two sides of a flat valley."""
    win_in, HM, bM, cfg = args[0], args[1], args[2], args[3]
    w_p = win_in._replace(x=prog[0].x.float(), c=prog[0].c.float(),
                          p_idepth=prog[0].p_idepth.float())
    e_p, _ = r_solve.total_energy(w_p, HM, bM, cfg)
    st = ref[1]
    return dict(ba_energy_gap=max(0.0, (e_p - st.energy_final) / max(st.energy_photo, 1e-12)))


def margf_numbers(prog, ref) -> dict:
    """A ``marginalize_frame``: the prior's larger relative Frobenius gap
    (HM, bM) after a keyframe's block is folded out."""
    (HMp, bMp), (HMr, bMr) = prog, ref
    return dict(marg_frame_gap=max(
        float(np.linalg.norm(HMp - HMr) / max(np.linalg.norm(HMr), 1e-30)),
        float(np.linalg.norm(bMp - bMr) / max(np.linalg.norm(bMr), 1e-30))))


def _parted(valid_p, valid_r, absolute=(), relative=()) -> tuple:
    """(rows parted, rows live): a row is parted where one side has it and
    the other not, or where both have it and a field of ``absolute``
    differs by more than 1e-3 (pixels), one of ``relative`` by more than
    1e-3 of max(|reference|, 1), or an integer or flag field differs."""
    valid_p, valid_r = valid_p.bool(), valid_r.bool()
    rows = valid_p != valid_r
    both = valid_p & valid_r
    for pairs, rel in ((absolute, False), (relative, True)):
        for a, b in pairs:
            if not a.is_floating_point():
                d = (a != b).to(torch.float64)
            else:
                a, b = a.double(), b.double()
                d = (a - b).abs()
                if rel:
                    d = d / torch.clamp(b.abs(), min=1.0)
                d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
            if d.dim() > 1:
                d = d.flatten(1).amax(1)
            rows = rows | (both & (d > 1e-3))
    return int(rows.sum()), int((valid_p | valid_r).sum())


def seed_numbers(prog, ref) -> dict:
    """A keyframe's seeding program: ``seed_rows_parted``, the share of
    candidate rows (corners and gradient pixels) that one side seeds and
    the other not, or seeds at another pixel, with another score, pattern
    colors or weights."""
    n, live = 0, 0
    if "corner_uv" in ref:
        n, live = _parted(prog["corner_valid"], ref["corner_valid"],
                          absolute=[(prog["corner_uv"], ref["corner_uv"])],
                          relative=[(prog["corner_score"], ref["corner_score"]),
                                    (prog["corner_color"], ref["corner_color"]),
                                    (prog["corner_weight"], ref["corner_weight"])])
    a, b = _parted(prog["sel_valid"], ref["sel_valid"], absolute=[(prog["sel_uv"], ref["sel_uv"])],
                   relative=[(prog["sel_color"], ref["sel_color"]),
                             (prog["sel_weight"], ref["sel_weight"])])
    return dict(seed_rows_parted=(n + a) / max(live + b, 1))


def patch_numbers(prog, ref) -> dict:
    """A ``compute_seed_patch`` (the merge of corners and gradient pixels
    into free bank rows), counted under ``seed_rows_parted``: bank rows
    dropped differently, and patch rows that go to another bank row or
    carry another seed, over the rows either side drops or fills."""
    N = ref[1].shape[0]
    a, b = _parted(prog[1] < N, ref[1] < N, absolute=[(prog[2], ref[2]), (prog[1], ref[1]),
                                                      (prog[5], ref[5])],
                   relative=[(prog[3], ref[3]), (prog[4], ref[4])])
    drop = int((prog[0] != ref[0]).sum())
    return dict(seed_rows_parted=(a + drop) / max(b + int((prog[0] | ref[0]).sum()), 1))


def project_numbers(prog, ref) -> dict:
    """The tracker reference's projection of the window's points into the
    new keyframe: ``ref_rows_parted``, the share of point rows that one
    side keeps and the other not, or that land elsewhere (1e-3 px) or
    carry another inverse depth (1e-6) or color."""
    a, b = _parted(prog[3], ref[3], absolute=[(prog[0], ref[0])],
                   relative=[(prog[1] * 1e3, ref[1] * 1e3), (prog[2], ref[2])])
    return dict(ref_rows_parted=a / max(b, 1))


def tref_numbers(prog, ref) -> dict:
    """``make_tracker_ref``: the same share over every level's rows,
    counted under ``ref_rows_parted``."""
    n, live = 0, 0
    for l in range(len(ref.uv)):
        a, b = _parted(prog.valid[l], ref.valid[l], absolute=[(prog.uv[l], ref.uv[l])],
                       relative=[(prog.idepth[l] * 1e3, ref.idepth[l] * 1e3),
                                 (prog.color[l], ref.color[l])])
        n, live = n + a, live + b
    return dict(ref_rows_parted=n / max(live, 1))


def init_numbers(prog, ref, args, kw) -> dict:
    """A bootstrap level (``init_level``, K6): ``init_energy_gap``, how far
    the level's objective at the program's final state lies above it at
    the reference's, both read by the reference on the reference's good
    points (after the snap the energy is flat along the scale gauge and
    float32 ladders part at accept ties, so the states may differ where
    the objective does not)."""
    system = r_init.level_system(args[0], args[1], args[2], args[9], **kw)
    good = ref.good.bool()
    e_p = float(system(prog.T.float(), prog.ab.float(), prog.idepth.float(),
                       prog.iR.float(), good)[5])
    e_r = float(system(ref.T, ref.ab, ref.idepth, ref.iR, good)[5])
    return dict(init_energy_gap=max(0.0, (e_p - e_r) / max(e_r, 1e-12)))


NUMBERS = {"activate": act_numbers, "marg": marg_numbers, "k4": k4_numbers,
           "solve": solve_numbers, "apply": apply_numbers, "margf": margf_numbers,
           "seed": seed_numbers, "patch": patch_numbers, "project": project_numbers,
           "tref": tref_numbers}


def compare(kept: dict, control: bool = False) -> dict:
    """Each number's worst reading over the kept calls: the program's
    results against the reference's (``control``: the reference in
    bfloat16 in the program's place)."""
    worst: dict = {}
    for name, recs in kept.items():
        for rec in recs:
            with torch.no_grad():
                prog = replay(name, rec, control=True) if control else rec["out"]
                if name == "step":
                    winner = (r_tracker.LAST_WINNER["T"], r_tracker.LAST_WINNER["ab"]) \
                        if control else rec.get("inner")
                    ref = replay(name, rec)
                    nums = step_numbers(prog, ref, _ref_types(name, rec["args"]), winner,
                                        r_tracker.LAST_WINNER["lanes"])
                else:
                    ref = replay(name, rec)
                    if name == "ba":
                        nums = ba_numbers(prog, ref, _ref_types(name, rec["args"]))
                    elif name == "init":
                        nums = init_numbers(prog, ref, rec["args"], rec["kw"])
                    else:
                        nums = NUMBERS[name](prog, ref)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
            del ref, prog
    return worst


# the fused step's diag vector: level-0 RMSE, keyframe vote (the
# reference's frame_step lays it out the same way)
DIAG_RMSE0, DIAG_KF_DELTA = 0, 6


def kf_vote(args, status):
    """(vote, level-0 RMSE, the first tracked frame's RMSE, whether a
    keyframe was built) of one ``FullSystem._process_tracked(self, fid, ts,
    exposure, out, ref_kf_id, T_ref_cw, diag, ...)`` call that tracked its
    frame; a keyframe built from the frame leaves its id in the status."""
    if not isinstance(status, dict) or status.get("status") != "tracked":
        return None
    diag = args[7]
    return (float(diag[DIAG_KF_DELTA]), float(diag[DIAG_RMSE0]),
            float(args[0].first_coarse_rmse), "kf_id" in status)


def decisions_parted(votes) -> float:
    """The share of the window's tracked frames where a keyframe was built
    or not against DSO's rule on the frame's own vote and RMSE: a keyframe
    where the vote passes 1 or the RMSE doubles the first tracked frame's."""
    parted = sum(built != (delta > 1.0 or 2.0 * first < rmse0)
                 for delta, rmse0, first, built in votes)
    return parted / max(len(votes), 1)


def segment_ate_pct(est: np.ndarray, gt: np.ndarray, seg: int) -> float:
    """The largest ATE (``umeyama_ate_pct``) of the trajectory's segments
    of ``seg`` frames, each aligned on its own (a tail shorter than half a
    segment joins the one before): monocular odometry without loop
    closing drifts in scale over many passes, and each pass is held to
    the limit alone."""
    n = len(est)
    cuts = list(range(0, n, seg)) + [n]
    if len(cuts) > 2 and cuts[-1] - cuts[-2] < seg // 2:
        del cuts[-2]
    return max(umeyama_ate_pct(est[a:b], gt[a:b]) for a, b in zip(cuts[:-1], cuts[1:]))


def umeyama_ate_pct(est: np.ndarray, gt: np.ndarray) -> float:
    """ATE RMSE after a Sim(3) Umeyama alignment, in % of the ground
    truth's bounding-box diagonal (``eval/ate.py``'s arithmetic)."""
    mu_s, mu_d = est.mean(0), gt.mean(0)
    xs, xd = est - mu_s, gt - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((xs ** 2).sum() / len(est), 1e-12))
    err = np.linalg.norm((s * (R @ est.T)).T + (mu_d - s * R @ mu_s) - gt, axis=1)
    return 100.0 * float(np.sqrt((err ** 2).mean())) / float(
        np.linalg.norm(gt.max(0) - gt.min(0)))
