"""The BA linearization on the card's path (K4): the dispatch of
``ba.residuals.assemble`` / ``energy_only`` (CPU -> the plain versions
``assemble_torch`` / ``energy_only_torch``, CUDA -> the kernel of
``kernels/ba.py``, anything else raises), the wrappers' refusals, a torch
emulation of the kernel's order (each task's words summed by its butterfly,
the tiles' tasks into per-CTA partials by ``kernels/ba.index_table``, the
partials added in CTA order by groups) against the plain version, a replay
of the pair tables the kernel makes (its expression, in torch ops)
against ``residuals.ba_slot_tables``, the plain versions against the JAX
package's ``assemble`` / ``energy_only``, chip_smoke's yardsticks (ties,
the bound, the run_ba comparison, the evaluation count) on the CPU, and, on
a card, the kernel against its plain version with chip_smoke's tie rule,
bit for bit in a second launch, at 1, 3, 10 and 32 slots, and the tables it
makes against ``ba_slot_tables`` bit for bit.

The window has the default shapes (2048 points, 10 slots, 640x480), made
with numpy from a seed: points hosted in six slots, four invalid slots (one
hosting a few points), points behind the camera at the current and at the
FEJ state, samples out of bounds, points whose res_mask holds their own
host, res_mask and p_valid holes, and a state moved off its FEJ point (pose,
affine, intrinsics, inverse depth), so that mode fej transports residuals.

The JAX package is imported inside the tests that use it, so that the
card's machine, which has no JAX, runs the kernel's tests:
``python -m pytest --noconftest -m gpu tests/test_torch_ba_kernel.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
import table_replay as tr
from ldso_tpu_torch.ba import residuals as tres
from ldso_tpu_torch.ba import solve as tsolve
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.core.window import PATTERN_OFFSETS, Window
from ldso_tpu_torch.io import synthetic
from ldso_tpu_torch.kernels import ba as kba
from ldso_tpu_torch.kernels import pyramid as tpyr
from ldso_tpu_torch.kernels.interp import in_bounds, pack_corners

CFG = preset("default")
HUB, OSUM = CFG.ba.huber_th, CFG.ba.outlier_th_sum_component
SLOTS = (0, 2, 3, 5, 7, 9)          # the valid slots, frames 0..5 of the sequence
N_EDGE = 16                          # edge points at the end of the bank (see _window)
# the emulation against the plain version: the same per-sample rows, sums
# over the same terms in another order (records, then points), each side
# float32: rtol 1e-5, with a floor of 1e-6 of the array's largest entry for
# entries that cancel
EMU_RTOL, EMU_ATOL_FRAC = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    """One intra-op thread while this file runs, as the other heavy files
    (six test processes share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(seed: int = 0, F: int = None, slots: tuple = SLOTS, P: int = None, w: int = 640,
            h: int = 480) -> dict:
    """The numpy fields of a window (see the module doc): the default
    shapes, or ``F`` slots of which ``slots`` are valid, ``P`` points."""
    F = F or CFG.shapes.max_frames
    P = P or CFG.shapes.max_points
    n = len(slots)
    ds = synthetic.SyntheticDataset(w=w, h=h, n=max(n, 2), seed=seed, supersample=1)
    ds.poses_w_c = synthetic.trajectory(max(n, 2), "forward_arc", step=0.1)
    ds._cache = {}
    rng = np.random.default_rng(seed + 21)
    a = dict(frame_valid=np.zeros(F, bool), T_eval=np.tile(np.eye(4, dtype=np.float32), (F, 1, 1)),
             x=np.zeros((F, 8), np.float32), x_zero=np.zeros((F, 8), np.float32),
             exposure=np.ones(F, np.float32), images=np.zeros((F, h, w, 3), np.float32))
    intr = np.asarray(ds.intrinsics(), np.float32)
    a["c_zero"] = intr
    a["c"] = (intr + np.asarray([0.3, -0.3, 0.2, 0.1], np.float32)).astype(np.float32)
    imgs = []
    for k, s in enumerate(slots):
        a["frame_valid"][s] = True
        a["T_eval"][s] = ds.gt_pose_c_w(k).astype(np.float32)
        a["x_zero"][s, 6:] = [0.02 * (k - 2.5), 0.5 * (k - 2.5)]
        a["x"][s] = a["x_zero"][s] + np.concatenate(
            [rng.normal(scale=3e-4, size=6), [0.01, 0.3]]).astype(np.float32)
        a["exposure"][s] = 1.0 + 0.05 * (k - 2.5)
        gain = a["exposure"][s] * np.exp(a["x"][s, 6])
        img = (gain * ds.get_image(k)[0] + a["x"][s, 7]).astype(np.float32)
        imgs.append(img)
        a["images"][s] = tpyr.build_pyramid_torch(torch.from_numpy(img), 1)[0][0].numpy()
    host_k = rng.integers(0, n, size=P)
    uv = np.zeros((P, 2), np.float32)
    color = np.zeros((P, 8), np.float32)
    weight = np.ones((P, 8), np.float32)
    idep = np.ones(P, np.float32)
    for k in range(n):
        gy, gx = np.gradient(imgs[k])
        g2 = gx ** 2 + gy ** 2
        d = ds.get_idepth(k)
        ok = (d > 1e-3) & (g2 > np.percentile(g2, 60))
        ok[:6] = ok[-6:] = False
        ok[:, :6] = ok[:, -6:] = False
        cand = np.argwhere(ok)
        rows = np.nonzero(host_k == k)[0]
        sel = cand[rng.choice(len(cand), size=len(rows), replace=False)]
        uv[rows] = np.stack([sel[:, 1], sel[:, 0]], -1)
        pu = (uv[rows][:, None, :] + PATTERN_OFFSETS[None]).astype(int)
        color[rows] = imgs[k][pu[..., 1], pu[..., 0]]
        weight[rows] = np.sqrt(OSUM / (OSUM + g2[pu[..., 1], pu[..., 0]]))
        idep[rows] = d[sel[:, 0], sel[:, 1]]
    a.update(p_host=np.asarray(slots, np.int32)[host_k], p_uv=uv, p_color=color,
             p_weight=weight.astype(np.float32))
    a["p_idepth"] = (idep * (1 + 0.02 * rng.normal(size=P))).astype(np.float32)
    a["p_idepth_zero"] = (a["p_idepth"] * (1 + 0.01 * rng.normal(size=P))).astype(np.float32)
    a["p_valid"] = rng.random(P) > 0.08
    res = a["frame_valid"][None, :] & (rng.random((P, F)) > 0.15)
    # a few keep their own host slot (every point, when it is the only slot)
    own = rng.random(P) < (0.05 if n > 1 else 1.0)
    res[np.arange(P), a["p_host"]] = own
    a["res_mask"] = res
    e = P - N_EDGE                                # the edge points
    a["p_valid"][e:] = True
    a["p_idepth"][e:e + 3] = -50.0                # behind the targets ahead, current state
    a["p_idepth_zero"][e + 3:e + 6] = -50.0       # the same at the FEJ state
    a["p_uv"][e + 6] = (3.0, 3.0)                 # pattern samples out of bounds
    a["p_uv"][e + 7] = (w - 4.0, h - 4.0)
    # its own host among its targets, 4e-4 px inside the border: a tie
    a["p_uv"][e + 8] = (2.0004, h / 2)
    a["res_mask"][e + 8, a["p_host"][e + 8]] = True
    if F > 1 and not a["frame_valid"][1]:
        a["p_host"][e + 9:e + 12] = 1             # hosted on an invalid slot
    a["res_mask"][e + 12] = False                 # nothing requested
    a["p_valid"][e + 13] = False                  # invalid, with a full res_mask
    a["res_mask"][e + 13] = a["frame_valid"]
    return a


@pytest.fixture(scope="module")
def window() -> dict:
    return _window()


def _twin(a: dict, device="cpu") -> Window:
    return Window(**{f: torch.as_tensor(np.array(a[f]), device=device) for f in Window._fields})


def _jwin(a: dict):
    import jax.numpy as jnp

    from ldso_tpu.core import window as jwin

    return jwin.Window(**{f: jnp.asarray(np.array(a[f])) for f in jwin.Window._fields})


def _close(t, j, rtol, atol_frac):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol_frac * max(np.abs(j).max(), 1e-30))


def _rows(win: Window, mode: str):
    """Every sample's rows as ``assemble_torch`` makes them (its own
    helpers): target8, host8, cam4 [P, F, 8, *], d, w = omega, w times the
    residual of the gradient and that residual, the energy, the validity
    [P, F, 8] and the per-pair ``requested`` [P, F]; mode "energy" only w,
    e and the validity (``energy_only_torch``'s)."""
    F, P = win.num_frames, win.num_points
    H_img, W_img = win.images.shape[1], win.images.shape[2]
    pre = tres.precompute_pairs(win)
    host = win.p_host.long()
    uvk, ok_pat = tres._project_current(win, pre, host)
    requested = win.res_mask & win.p_valid[:, None] & win.frame_valid[None, :]
    if mode == "energy":
        valid = ok_pat & requested[..., None]
        r, _, hw, omega = tres._photometric(win, pre, host, uvk, valid, pack_corners(win.images),
                                            HUB, OSUM)
        return dict(w=omega, e=omega * r * r * (2.0 - hw), valid=valid, requested=requested)
    fx0, fy0 = win.c_zero[0], win.c_zero[1]
    R_fej, t_fej = pre.R_fej[host], pre.t_fej[host]
    xc = tres._normalized_dirs(win.p_uv, win.c_zero)
    X0 = torch.einsum("pfij,pj->pfi", R_fej, xc) + t_fej * win.p_idepth_zero[:, None, None]
    z0 = X0[..., 2]
    ok_fej = z0 > 1e-6
    dre = 1.0 / torch.where(ok_fej, z0, torch.ones_like(z0))
    up0, vp0 = X0[..., 0] * dre, X0[..., 1] * dre
    ok_fej = ok_fej & in_bounds(torch.stack([fx0 * up0 + win.c_zero[2],
                                             fy0 * vp0 + win.c_zero[3]], -1), W_img, H_img, 2.0)
    Jp_pose = tres._pose_jacobian(up0, vp0, win.p_idepth_zero[:, None] * dre, fx0, fy0)
    Jp_cam = tres._cam_jacobian(up0, vp0, dre, xc[:, None, :], R_fej, fx0, fy0, win.c_zero)
    Jp_d = torch.stack([fx0 * dre * (t_fej[..., 0] - t_fej[..., 2] * up0),
                        fy0 * dre * (t_fej[..., 1] - t_fej[..., 2] * vp0)], -1)
    valid = ok_pat & ok_fej[..., None] & requested[..., None]
    r, g, hw, omega = tres._photometric(win, pre, host, uvk, valid, pack_corners(win.images),
                                        HUB, OSUM)
    Jt = g @ Jp_pose
    Jh = -(Jt @ pre.adj_fej[host])
    c4 = g @ Jp_cam
    d = torch.einsum("pfkg,pfg->pfk", g, Jp_d)
    a_fej = pre.alpha_fej[host]
    col0 = (win.p_color - pre.b_host_fej[host][:, None])[:, None, :]
    t8 = torch.cat([Jt, (-a_fej[..., None] * col0)[..., None],
                    -torch.ones_like(Jt[..., :1])], -1)
    h8 = torch.cat([Jh, (a_fej[..., None] * col0)[..., None],
                    (a_fej[..., None] * torch.ones_like(col0))[..., None]], -1)
    r_used = r
    if mode == "fej":
        delta = tres.state_delta(win)
        dF, dC = delta[:8 * F].reshape(F, 8), delta[8 * F:]
        r_used = r - (torch.einsum("pfka,fa->pfk", t8, dF)
                      + torch.einsum("pfka,pa->pfk", h8, dF[host])
                      + torch.einsum("pfka,a->pfk", c4, dC)
                      + d * (win.p_idepth - win.p_idepth_zero)[:, None, None])
    return dict(t8=t8, h8=h8, c4=c4, d=d, w=omega, wr=omega * r_used, r=r_used,
                e=omega * r * r * (2.0 - hw), valid=valid, requested=requested)


def _butterfly8(v):
    """The kernel's sum over a group's 8 lanes (dim -2): lanes (k, k ^ 4),
    then (k, k ^ 2), then (k, k ^ 1)."""
    a = v[..., 0:4, :] + v[..., 4:8, :]
    b = a[..., 0:2, :] + a[..., 2:4, :]
    return b[..., 0, :] + b[..., 1, :]


def _sample_words(s, f: int, mode: str):
    """Slot f's samples' words [P, 8, GROUP_WORDS] and [P, 8, POINT_WORDS]
    (``csrc/ba.cu``'s group_word / point_word), zero for an invalid sample;
    mode "energy": [P, 8, 2] (the energy, the count)."""
    valid = s["valid"][:, f]
    n = valid.float()
    e = torch.where(valid, s["e"][:, f], 0.0)
    if mode == "energy":
        return None, torch.stack([e, n], -1)
    t8, h8, c4 = s["t8"][:, f], s["h8"][:, f], s["c4"][:, f]
    w, d, wr, r = s["w"][:, f], s["d"][:, f], s["wr"][:, f], s["r"][:, f]
    wd = w * d
    i8, i4 = torch.triu_indices(8, 8), torch.triu_indices(4, 4)
    wt, wh, wc = w[..., None] * t8, w[..., None] * h8, w[..., None] * c4
    group = torch.cat([wt[..., i8[0]] * t8[..., i8[1]],
                       (wh[..., :, None] * t8[..., None, :]).flatten(-2),
                       (wt[..., :, None] * c4[..., None, :]).flatten(-2),
                       t8 * wr[..., None], t8 * wd[..., None], e[..., None]], -1)
    point = torch.cat([wh[..., i8[0]] * h8[..., i8[1]],
                       (wh[..., :, None] * c4[..., None, :]).flatten(-2),
                       h8 * wr[..., None], wc[..., i4[0]] * c4[..., i4[1]], c4 * wr[..., None],
                       e[..., None], n[..., None], h8 * wd[..., None], c4 * wd[..., None],
                       (wd * d)[..., None], (wd * r)[..., None]], -1)
    assert group.shape[-1] == kba.GROUP_WORDS and point.shape[-1] == kba.POINT_WORDS
    return (torch.where(valid[..., None], group, 0.0),
            torch.where(valid[..., None], point, 0.0))


def _emulate(win: Window, mode: str, sms: int = 132):
    """The kernel's order in torch (``csrc/ba.cu``): each task's words (a
    point's pass of 4 valid target slots) by the butterfly, the per-point
    outputs from them, each CTA's partial system over its tiles' tasks by
    ``kernels/ba.index_table`` (terms in order, tasks in order), the
    partials added in CTA order by groups of GROUP_SIZE, then the groups.
    Returns what ``assemble`` returns (a dict), or (energy, count) in mode
    "energy"."""
    F, P = win.num_frames, win.num_points
    D = 8 * F + 4
    host = win.p_host.long().clamp(0, F - 1)
    s = _rows(win, mode)
    vs = [f for f in range(F) if bool(win.frame_valid[f])]
    QP = kba.passes(len(vs))
    GW, PW = kba.GROUP_WORDS, kba.POINT_WORDS
    tg = torch.zeros(P, QP, 4, GW)                     # a task's pair words
    pp = torch.zeros(P, QP, 4, PW)                     # its groups' point-word partials
    ev = torch.zeros(P, QP, 4, 8, 2)                   # energy_only: its lanes' (e, n)
    for vi, f in enumerate(vs):
        group, point = _sample_words(s, f, mode)
        if mode == "energy":
            ev[:, vi // 4, vi % 4] = point
        else:
            tg[:, vi // 4, vi % 4] = _butterfly8(group)
            pp[:, vi // 4, vi % 4] = _butterfly8(point)
    nonempty = s["valid"][:, vs].any(-1) if vs else torch.zeros(P, 0, dtype=torch.bool)
    nonempty = torch.cat([nonempty, torch.zeros(P, 4 * QP - len(vs), dtype=torch.bool)], 1)
    nonempty = nonempty.view(P, QP, 4).any(-1)
    if mode == "energy":
        # over the 32 lanes: (g, g ^ 2), (g, g ^ 1), then the group butterfly
        g = (ev[:, :, 0] + ev[:, :, 2]) + (ev[:, :, 1] + ev[:, :, 3])
        tp = torch.zeros(P, QP, PW)
        tp[..., [kba.PE, kba.PN]] = _butterfly8(g)
        table = torch.as_tensor(kba.energy_table()).long()
    else:
        tp = (pp[:, :, 0] + pp[:, :, 1]) + (pp[:, :, 2] + pp[:, :, 3])
        table = torch.as_tensor(kba.index_table(F)).long()
    staged = torch.cat([tg.reshape(P, QP, 4 * GW), tp], -1)     # [P, QP, 702]
    n = table.shape[0]
    # each term's place in a task's staging, the pass it needs, its host condition
    terms = []
    for j in range(4):
        t = table[:, j]
        word, src, cond = t & 255, (t >> 8) & 63, (t >> 16) & 63
        vidx = torch.tensor([vs.index(x) if x in vs else -1 for x in range(kba.SRC_POINT + 1)])
        vi = vidx[src.clamp(max=kba.SRC_POINT)]
        point_src = src == kba.SRC_POINT
        present = (t >= 0) & (point_src | (vi >= 0))
        off = torch.where(point_src, 4 * GW + word, (vi % 4) * GW + word)
        terms.append((present, off.clamp(0, staged.shape[-1] - 1),
                      torch.where(point_src, -1, vi // 4), cond))
    NPT = kba.WARPS // QP
    tiles = -(-P // NPT)
    G = kba.grid_size(P, F, sms)
    part = torch.zeros(G, n)
    pidx, qidx = torch.arange(NPT).repeat_interleave(QP), torch.arange(QP).repeat(NPT)
    for tile in range(tiles):
        c, p0 = tile % G, tile * NPT
        ok = p0 + pidx < P
        pt, qt = (p0 + pidx)[ok], qidx[ok]
        ht, live = host[pt], nonempty[pt, qt]
        v = part[c]
        for present, off, qreq, cond in terms:
            vals = staged[pt, qt][:, off]                                 # [tasks, n]
            use = (present[None] & live[:, None] & ((qreq[None] < 0) | (qreq[None] == qt[:, None]))
                   & ((cond[None] == kba.ALWAYS) | (cond[None] == ht[:, None])))
            for tau in range(len(pt)):
                v = v + torch.where(use[tau], vals[tau], 0.0)
        part[c] = v
    gs = []
    for g0 in range(0, G, kba.GROUP_SIZE):
        acc = part[g0]
        for b in range(g0 + 1, min(g0 + kba.GROUP_SIZE, G)):
            acc = acc + part[b]
        gs.append(acc)
    total = gs[0]
    for acc in gs[1:]:
        total = total + acc
    out0, out1 = table[:, 4], table[:, 5]
    counting = out0 < 0
    count = int(total[counting].round().item())
    if mode == "energy":
        return total[~counting][0], count
    out = torch.full((D * D + D + 1,), float("nan"))
    out[out0[~counting]] = total[~counting]
    m = out1 >= 0
    out[out1[m]] = total[m]
    # the points' own outputs: their passes added in pass order
    H_xd = torch.zeros(P, D)
    for vi, f in enumerate(vs):
        H_xd[:, 8 * f:8 * f + 8] = tg[:, vi // 4, vi % 4, kba.HX:kba.HX + 8]
    hh, hc, hdd, bd = (torch.zeros(P, 8), torch.zeros(P, 4), torch.zeros(P), torch.zeros(P))
    for q in range(QP):
        hh = hh + tp[:, q, kba.HXH:kba.HXH + 8]
        hc = hc + tp[:, q, kba.HXC:kba.HXC + 4]
        hdd = hdd + tp[:, q, kba.HDD]
        bd = bd + tp[:, q, kba.BD]
    rows = torch.arange(P)
    cols = 8 * host[:, None] + torch.arange(8)[None]
    H_xd[rows[:, None], cols] = H_xd[rows[:, None], cols] + hh
    H_xd[:, 8 * F:] = hc
    e_pair = torch.zeros(P, F)
    for vi, f in enumerate(vs):
        e_pair[:, f] = tg[:, vi // 4, vi % 4, kba.GE]
    valid_pair = s["valid"].any(-1)
    return dict(H=out[:D * D].reshape(D, D), b=out[D * D:D * D + D], energy=out[-1],
                num_res=count, H_xd=H_xd, H_dd=hdd, b_d=bd, e_pair=e_pair,
                valid_pair=valid_pair, oob_pair=s["requested"] & ~valid_pair)


def _replay_slot_tables(win: Window, rules: tuple) -> tuple:
    """(pair [F, F, 62], slot [F, 3]) by the kernel's expression
    (csrc/ba.cu slot_entry, make_pair; ``table_replay``'s rules)."""
    modes = rules[0]
    x, xz, Te, ex = win.x, win.x_zero, win.T_eval, win.exposure
    F = x.shape[0]
    Tc, Tv = tr.exp_times(x, Te, rules), tr.rows(Te)

    def rel(Tt, Ti):                  # [h, t] = T_t T_h^-1
        return tr.mul([[e[None, :] for e in r] for r in Tt],
                      [[e[:, None] for e in r] for r in Ti], modes["rel"])

    rc = rel(Tc, tr.inverse(Tc, modes["inv"]))
    rf = rel(Tv, tr.inverse(Tv, modes["inv"]))
    zz = torch.zeros(F, F)
    tf = [rf[i][3] for i in range(3)]
    ht = [[zz, -tf[2], tf[1]], [tf[2], zz, -tf[0]], [-tf[1], tf[0], zz]]
    tR = [[tr.dot([(ht[i][m], rf[m][j]) for m in range(3)], modes["adj"]) for j in range(3)]
          for i in range(3)]
    adj = [[(rf[i][j] if j < 3 else tR[i][j - 3]) if i < 3 else (zz if j < 3 else rf[i - 3][j - 3])
            for j in range(6)] for i in range(6)]
    eac, eaf = ex * torch.exp(x[:, 6]), ex * torch.exp(xz[:, 6])
    cols = ([rc[i][j] for i in range(3) for j in range(3)] + [rc[i][3] for i in range(3)]
            + [rf[i][j] for i in range(3) for j in range(3)] + [rf[i][3] for i in range(3)]
            + [adj[i][j] for i in range(6) for j in range(6)]
            + [eac[None, :] / eac[:, None], eaf[None, :] / eaf[:, None]])
    return torch.stack(cols, -1), torch.stack([x[:, 7], xz[:, 7], x[:, 7]], -1)


def _pose_window(F: int, angle: float, seed: int = 0, device="cpu") -> Window:
    """A window whose poses and affine states are random (rotations of
    about ``angle`` rad in T_eval and x), its points a placeholder."""
    from ldso_tpu_torch.math import lie

    rng = np.random.default_rng(seed)
    xi = torch.as_tensor(np.concatenate([rng.normal(size=(F, 3)),
                                         rng.normal(size=(F, 3)) * angle], 1), dtype=torch.float32)
    x = rng.normal(size=(F, 8)) * 0.1
    x[:, 3:6] = rng.normal(size=(F, 3)) * angle
    a = dict(frame_valid=np.ones(F, bool), T_eval=lie.se3_exp(xi).numpy(),
             x=x.astype(np.float32), x_zero=(rng.normal(size=(F, 8)) * 0.1).astype(np.float32),
             exposure=(1 + 0.1 * rng.random(F)).astype(np.float32),
             images=np.zeros((F, 16, 16, 3), np.float32), c=np.ones(4, np.float32),
             c_zero=np.ones(4, np.float32), p_valid=np.zeros(4, bool),
             p_host=np.zeros(4, np.int32), p_uv=np.zeros((4, 2), np.float32),
             p_color=np.zeros((4, 8), np.float32), p_weight=np.zeros((4, 8), np.float32),
             p_idepth=np.ones(4, np.float32), p_idepth_zero=np.ones(4, np.float32),
             res_mask=np.zeros((4, F), bool))
    return _twin(a, device)


# ---- on the CPU

def test_window_has_the_default_shapes_and_several_hosts(window):
    win = _twin(window)
    assert (win.num_points, win.num_frames, tuple(win.images.shape[1:3])) == (2048, 10, (480, 640))
    assert len(np.unique(window["p_host"][window["p_valid"]])) == len(SLOTS) + 1
    plain = tres.assemble_torch(win, HUB, OSUM)
    vp, oob = plain.valid_pair.numpy(), plain.oob_pair.numpy()
    e = win.num_points - N_EDGE
    assert int(plain.num_res) > 40_000 and oob.sum() > 100
    assert oob[e:e + 6].any(1).all()                          # behind some camera
    assert not vp[e + 12:e + 14].any() and not oob[e + 12:e + 14].any()


@pytest.mark.parametrize("mode", ["active", "fej", "energy"])
def test_emulated_kernel_order_equals_plain(window, mode):
    win = _twin(window)
    emu = _emulate(win, mode)
    if mode == "energy":
        E, n = tres.energy_only_torch(win, HUB, OSUM)
        assert emu[1] == int(n)
        np.testing.assert_allclose(float(emu[0]), float(E), rtol=EMU_RTOL)
        return
    plain = tres.assemble_torch(win, HUB, OSUM, mode)
    assert not torch.isnan(emu["H"]).any() and torch.equal(emu["H"], emu["H"].T)
    assert emu["num_res"] == int(plain.num_res)
    for f in ("valid_pair", "oob_pair"):
        assert torch.equal(emu[f], getattr(plain, f)), f
    for f in ("H", "b", "H_xd", "H_dd", "b_d", "e_pair"):
        _close(emu[f].numpy(), getattr(plain, f).numpy(), EMU_RTOL, EMU_ATOL_FRAC)
    np.testing.assert_allclose(float(emu["energy"]), float(plain.energy), rtol=EMU_RTOL)


@pytest.mark.parametrize("F", [1, 3, 10, 32])
def test_index_table_writes_every_entry_once(F):
    D = 8 * F + 4
    t = kba.index_table(F)
    assert t.shape == (kba.entries(F), kba.TABLE_WORDS)
    assert t.shape[0] == 8 * F * (8 * F + 1) // 2 + 32 * F + 10 + D + 2
    out0, out1 = t[:, 4], t[:, 5]
    outs = np.concatenate([out0[out0 >= 0], out1[out1 >= 0]])
    assert sorted(outs.tolist()) == list(range(D * D + D + 1))
    assert (out0 < 0).sum() == 1 and out1[out0 < 0] == -1 and out0[-1] == -1
    # the kernel writes output o from entry output_entries(F)[o]
    inv = kba.output_entries(F)
    assert inv.shape == (D * D + D + 1,) and inv.min() >= 0
    assert ((out0[inv] == np.arange(inv.size)) | (out1[inv] == np.arange(inv.size))).all()
    terms = t[:, :4][t[:, :4] >= 0]
    word, src, cond = terms & 255, (terms >> 8) & 63, (terms >> 16) & 63
    point = src == kba.SRC_POINT
    assert ((src < F) | point).all() and ((cond < F) | (cond == kba.ALWAYS)).all()
    assert (word[point] < kba.POINT_WORDS).all() and (word[~point] < kba.GROUP_WORDS).all()
    assert (terms >> 22 == 0).all() and (t[:, 6:] == 0).all()
    # every entry counts at least one term, each (source, word) for one entry
    # of the upper triangle and b (a mirrored off-diagonal word twice)
    assert (t[:, 0] >= 0).all()
    assert np.array_equal(kba.energy_table()[:, 4:6], [[0, -1], [-1, -1]])
    assert np.array_equal(kba.output_entries(None), [0])


@pytest.mark.parametrize("F", [1, 3, 10])
@pytest.mark.parametrize("angle", [1e-6, 1.0])
def test_slot_table_replay_is_bitwise(F, angle):
    # the kernel's expression with the CPU's rounding rules gives the CPU's
    # ba_slot_tables bit for bit: the small-angle branch (angle 1e-6) and
    # the general one
    win = _pose_window(F, angle, seed=F)
    pair, slot = tres.ba_slot_tables(win)
    rp, rs = _replay_slot_tables(win, tr.cpu_rules(F))
    assert rp.shape == pair.shape == (F, F, kba.PAIR_TABLE)
    assert torch.equal(rp.view(torch.int32), pair.view(torch.int32))
    assert torch.equal(rs.view(torch.int32), slot.view(torch.int32))
    small = bool((win.x[:, 3:6].square().sum(-1) < 1e-8).all())
    assert small == (angle < 1e-3)


@pytest.mark.parametrize("mode", ["active", "fej"])
def test_plain_assemble_matches_jax(window, mode):
    from ldso_tpu.ba import residuals as jres

    sj = jres.assemble(_jwin(window), huber_th=HUB, outlier_sum=OSUM, mode=mode)
    st = tres.assemble_torch(_twin(window), HUB, OSUM, mode)
    assert int(st.num_res) == int(sj.num_res)
    for f in ("valid_pair", "oob_pair"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))
    # tests/test_torch_ba.py's tolerances: sums in another order
    for f in ("H", "b", "H_xd", "H_dd", "b_d", "e_pair"):
        _close(getattr(st, f).numpy(), np.asarray(getattr(sj, f)), 1e-3, 1e-5)
    np.testing.assert_allclose(float(st.energy), float(sj.energy), rtol=1e-4)


def test_plain_energy_only_matches_jax(window):
    from ldso_tpu.ba import residuals as jres

    ej, nj = jres.energy_only(_jwin(window), huber_th=HUB, outlier_sum=OSUM)
    et, nt = tres.energy_only_torch(_twin(window), HUB, OSUM)
    assert int(nt) == int(nj)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-4)


def test_dispatch_takes_the_plain_versions_for_cpu_tensors(window):
    win = _twin(window)
    for mode in ("active", "fej"):
        a, b = tres.assemble(win, HUB, OSUM, mode), tres.assemble_torch(win, HUB, OSUM, mode)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (mode, f)
    for x, y in zip(tres.energy_only(win, HUB, OSUM), tres.energy_only_torch(win, HUB, OSUM)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unknown assemble mode"):
        tres.assemble(win, HUB, OSUM, "nope")
    meta = Window(*(t.to("meta") for t in win))
    with pytest.raises(ValueError, match="no BA assembly for device"):
        tres.assemble(meta, HUB, OSUM)
    with pytest.raises(ValueError, match="no BA energy for device"):
        tres.energy_only(meta, HUB, OSUM)


def test_wrappers_refuse_cpu_wrong_dtypes_and_non_contiguous_tensors(window):
    win = _twin(window)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kba.assemble_cuda(win, HUB, OSUM)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kba.energy_only_cuda(win, HUB, OSUM)
    with pytest.raises(ValueError, match="unknown assemble mode"):
        kba.assemble_cuda(win, HUB, OSUM, "energy")
    meta = Window(*(t.to("meta") for t in win))
    with pytest.raises(ValueError, match="tensors on meta and cpu"):
        kba.assemble_cuda(meta._replace(p_uv=win.p_uv), HUB, OSUM)
    # the checks before the device's: dtype, shape, contiguity
    with pytest.raises(TypeError, match="p_host is torch.int64"):
        kba._inputs(win._replace(p_host=win.p_host.long()))
    with pytest.raises(ValueError, match="p_uv is not contiguous"):
        kba._inputs(win._replace(p_uv=torch.cat([win.p_uv, win.p_uv], 1)[:, :2]))
    with pytest.raises(ValueError, match="res_mask has shape"):
        kba._inputs(win._replace(res_mask=win.res_mask[:, :9].contiguous()))
    with pytest.raises(ValueError, match="33 slots"):
        kba._inputs(win._replace(images=torch.zeros(33, 4, 4, 3)))


def test_slot_tables_are_the_plain_versions_values(window):
    win = _twin(window)
    pair, slot = tres.ba_slot_tables(win)
    pre = tres.precompute_pairs(win)
    F = win.num_frames
    parts = torch.split(pair, [9, 3, 9, 3, 36, 1, 1], dim=-1)
    for got, want in zip(parts, (pre.R_cur, pre.t_cur, pre.R_fej, pre.t_fej, pre.adj_fej,
                                 pre.alpha_cur, pre.alpha_fej)):
        assert torch.equal(got.reshape(want.shape), want)
    assert torch.equal(slot, torch.stack([pre.b_host_cur, pre.b_host_fej, pre.b_tgt_cur], -1))
    assert pair.is_contiguous() and slot.is_contiguous() and F == 10


def test_wrapper_imports_without_nvcc():
    # nothing is built at import: no nvcc on PATH, no CUDA_HOME
    code = ("import ldso_tpu_torch.kernels.ba as k, ldso_tpu_torch.ba.solve, "
            "ldso_tpu_torch.kernels.cuda_build as b\n"
            "assert k.LAUNCHES == 0 and k.index_table(10).shape[0] == 3656\n"
            "try:\n    b.nvcc()\nexcept RuntimeError:\n    pass\n"
            "else:\n    raise SystemExit('nvcc found')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=os.path.join(root, "no-cuda-here"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("mode", ["active", "fej", "energy"])
def test_chip_smoke_bound_and_ties(window, mode):
    win = _twin(window)
    ms, by, n_bytes, flops = cs.ba_assemble_bound_ms(win, mode)
    P, F = win.num_points, win.num_frames
    D = 8 * F + 4
    s = _rows(win, mode)
    n_valid = int(s["valid"].sum())
    # every input and output once, and 12 B a texel of at least a quarter of
    # the valid samples' corners
    floor = P * (81 + F) + (12 if mode == "energy" else 4 * (D * D + D + 1) + P * (4 * D + 8))
    assert n_bytes > floor + 12 * n_valid // 4
    assert flops >= cs.K4_FLOPS_REQ * 8 * int(s["requested"].sum()) + n_valid
    t_bytes, t_ops = n_bytes / cs.HBM_BYTES_PER_S, flops / cs.FP32_FLOPS_PER_S
    assert ms == pytest.approx(1e3 * max(t_bytes, t_ops))
    assert by == ("bytes" if t_bytes >= t_ops else "operations")
    tie = cs.ba_tie_pairs(win, mode)
    assert tie.dtype == torch.bool and tie.shape == (P, F)
    assert not bool((tie & ~s["requested"]).any())
    e = P - N_EDGE
    assert bool(tie[e + 8, int(win.p_host[e + 8])])
    # the plain version's own decisions at a sample, as ba_samples gives them
    uvk, ok_pat, uv0, ok0 = cs.ba_samples(win)
    want = ok_pat & s["requested"][..., None]
    if mode != "energy":
        h, w = win.images.shape[1], win.images.shape[2]
        want &= (ok0 & in_bounds(uv0, w, h, 2.0))[..., None]
    assert torch.equal(want, s["valid"])


@pytest.mark.parametrize("mode", ["active", "fej"])
def test_chip_smoke_ba_compare(window, mode):
    # the plain version against itself holds; an entry of b moved by its
    # bound's worth, or a flipped mask, does not
    win = _twin(window)
    plain = tres.assemble_torch(win, HUB, OSUM, mode)
    rec = cs.ba_compare(plain, plain, mode, win)
    assert rec["all"] and rec["used"] == 0.0 and rec["pairs"].all() and rec["points"].all()
    # the bound of b[3], read from a probe move; a third of it holds, 3x not
    i, probe = 3, plain.b.clone()
    probe[i] += 1.0
    ratio = cs.ba_compare(plain._replace(b=probe), plain, mode, win)["worst"]["b"]
    assert ratio[1] == (i,) and ratio[0] > 0
    for times, holds in ((0.3, True), (3.0, False)):
        moved = plain.b.clone()
        moved[i] += times / ratio[0]
        assert cs.ba_compare(plain._replace(b=moved), plain, mode, win)["all"] == holds
    flipped = plain.valid_pair.clone()
    flipped[0, 0] = ~flipped[0, 0]
    rec = cs.ba_compare(plain._replace(valid_pair=flipped), plain, mode, win)
    assert not rec["all"] and not rec["pairs"][0, 0] and rec["pairs"].sum() == rec["pairs"].size - 1


def test_chip_smoke_run_ba_replay_and_counts():
    # the replay of kept run_ba arguments on the CPU: a run against its own
    # repeat holds; a ladder that parts at a tie is reported, at no tie raises
    from ldso_tpu_torch.ba import marginal
    from ldso_tpu_torch.eval.toys import make_synthetic_window

    cfg = preset("tiny")
    win, _ = make_synthetic_window(cfg, w=160, h=120, n_frames=3, idepth_noise=0.05,
                                   pose_noise=0.003, device="cpu")
    D = cfg.shapes.state_dim
    HM, bM = np.zeros((D, D)), np.zeros(D)
    run_ba = tsolve.run_ba
    with cs.count_ba() as evals:
        w1, s1 = tsolve.run_ba(win, HM, bM, cfg, anchor_slot=0)
        mask = np.zeros(win.num_points, bool)
        marginal.marginalize_points(win, mask, HM, bM, cfg)          # folds nothing
        mask[:5] = True
        marginal.marginalize_points(win, mask, HM, bM, cfg)
    assert tsolve.run_ba is run_ba and evals[0] == 1 + len(s1.lam_ladder) + 1
    assert len(s1.energy_ladder) == len(s1.lam_ladder) >= 1
    w2, s2 = tsolve.run_ba(*cs._clone((win, HM, bM, cfg)), anchor_slot=0)
    rec = cs.compare_run_ba("tiny", w1, s1, w2, s2)
    assert rec["e_x"] == 0.0 and rec["masks_parted"] == 0
    E0 = s1.energy_initial
    tied = s1._replace(lam_ladder=[1.0] + s1.lam_ladder[1:],
                       energy_ladder=[E0 * (1 - 1e-7)] + s1.energy_ladder[1:])
    assert cs.compare_run_ba("tie", w1, tied, w2, tied._replace(
        lam_ladder=[2.0] + s1.lam_ladder[1:]))["tie_at"] == 0
    far = tied._replace(energy_ladder=[E0 * 0.5] + s1.energy_ladder[1:])
    with pytest.raises(RuntimeError, match="no tie"):
        cs.compare_run_ba("no tie", w1, far, w2, far._replace(
            lam_ladder=[2.0] + s1.lam_ladder[1:]))
    # the window marginalize_points folds
    mw = cs.marg_window((win, mask, HM, bM, cfg))
    assert torch.equal(mw.p_valid, win.p_valid & torch.as_tensor(mask))


# ---- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["active", "fej", "energy"])
def test_cuda_assemble_matches_plain(cuda, window, mode):
    win = _twin(window, device=cuda)
    before = kba.LAUNCHES
    rec = cs.check_ba(f"test window, {mode}", win, CFG, mode)      # ties, a bitwise repeat
    assert kba.LAUNCHES >= before + 2 * kba.PER_EVALUATION
    assert rec["hosts"] == len(SLOTS) + 1 and rec["num_res"] > 40_000
    assert rec["table"]["entries"] == 0 and rec["table"]["slot_equal"], rec["table"]


OTHER_SLOTS = {1: (0,), 3: (0, 2), 32: (0, 5, 11, 17, 25, 31)}


def _other_window(F: int) -> dict:
    return _window(seed=F, F=F, slots=OTHER_SLOTS[F], P=512, w=320, h=240)


@pytest.mark.parametrize("F", [3, 32])
def test_emulated_kernel_order_at_other_slot_counts(F):
    # 3 slots (one pass) and MAX_SLOTS (6 valid of 32: two passes, the
    # host blocks spread over the whole system)
    win = _twin(_other_window(F))
    emu = _emulate(win, "active")
    plain = tres.assemble_torch(win, HUB, OSUM)
    assert emu["num_res"] == int(plain.num_res) > 1000
    for f in ("valid_pair", "oob_pair"):
        assert torch.equal(emu[f], getattr(plain, f)), f
    for f in ("H", "b", "H_xd", "H_dd", "b_d", "e_pair"):
        _close(emu[f].numpy(), getattr(plain, f).numpy(), EMU_RTOL, EMU_ATOL_FRAC)


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 3, 32])
def test_cuda_assemble_at_other_slot_counts(cuda, F):
    # 3 slots and MAX_SLOTS (6 valid among 32): the kernel against the
    # plain version in both modes and energy_only, a bitwise repeat, its
    # pair tables bit for bit. One slot: every residual is its point's own
    # host's, projected through the identity, so its Jacobians cancel
    # exactly (target8 + host8 = 0, and no pixel moves with the intrinsics
    # or the inverse depth): H, b, H_xd, H_dd and b_d are rounding noise in
    # both versions; held there: the masks, the count, the energy, e_pair,
    # a bitwise repeat, finite outputs
    win = _twin(_other_window(F), device=cuda)
    if F > 1:
        for mode in ("active", "fej", "energy"):
            rec = cs.check_ba(f"{F} slots, {mode}", win, CFG, mode)
            assert rec["num_res"] > 1000 and rec["slots"] == len(OTHER_SLOTS[F])
            assert rec["table"]["entries"] == 0 and rec["table"]["slot_equal"], rec["table"]
        return
    k, p = tres.assemble(win, HUB, OSUM), tres.assemble_torch(win, HUB, OSUM)
    again = tres.assemble(win, HUB, OSUM)
    for f in k._fields:
        assert cs._bits_equal(getattr(k, f), getattr(again, f)), f
    assert int(k.num_res) == int(p.num_res) > 1000
    assert torch.equal(k.valid_pair, p.valid_pair) and torch.equal(k.oob_pair, p.oob_pair)
    np.testing.assert_allclose(float(k.energy), float(p.energy), rtol=cs.K4_E_RTOL)
    _close(k.e_pair.cpu().numpy(), p.e_pair.cpu().numpy(), cs.K4_RTOL, cs.K4_ATOL_FRAC)
    for f in ("H", "b", "H_xd", "H_dd", "b_d"):
        assert bool(torch.isfinite(getattr(k, f)).all()), f


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 3, 10, 32])
@pytest.mark.parametrize("angle", [1e-6, 1.0])
def test_cuda_slot_tables_equal_plain(cuda, F, angle):
    # the tables the kernel makes equal ba_slot_tables on the card bit for
    # bit: the small-angle branch and the general one, one chain or split
    win = _pose_window(F, angle, seed=F, device=cuda)
    rec = cs.ba_table_compare(win)
    assert rec["entries"] == 0 and rec["slot_equal"], rec


@pytest.mark.gpu
def test_cuda_outputs_are_fresh_and_typed(cuda, window):
    win = _twin(window, device=cuda)
    before = kba.LAUNCHES
    a = tres.assemble(win, HUB, OSUM)
    b = tres.assemble(win, HUB, OSUM)
    torch.cuda.synchronize()
    assert kba.LAUNCHES == before + 2 * kba.PER_EVALUATION
    plain = tres.assemble_torch(win, HUB, OSUM)
    for f in a._fields:
        x, y = getattr(a, f), getattr(plain, f)
        assert (x.dtype, x.shape, x.device) == (y.dtype, y.shape, y.device), f
        assert getattr(b, f).data_ptr() != x.data_ptr() or x.numel() == 0
    E, n = tres.energy_only(win, HUB, OSUM)
    assert E.dtype == torch.float32 and n.dtype == torch.int64 and E.dim() == n.dim() == 0


@pytest.mark.gpu
def test_cuda_run_ba_matches_plain(cuda, window):
    # without the points hosted on the empty slot 1: a window never hosts a
    # point on a slot that holds no frame, and rounding sets their inverse
    # depths (the plain version against itself, its systems moved by 1e-7
    # relative noise, ends two of them 0.4% and 0.2% apart, beyond run_ba's
    # bounds, where the BA takes one from 0.07 to 2.2); the assembly cases
    # above keep them
    a = dict(window, p_valid=window["p_valid"] & (window["p_host"] != 1))
    win = _twin(a, device=cuda)
    D = CFG.shapes.state_dim
    rec = cs.check_run_ba("test window", (win, np.zeros((D, D)), np.zeros(D), CFG),
                          dict(anchor_slot=0))
    assert rec["iterations"][1] >= 1
