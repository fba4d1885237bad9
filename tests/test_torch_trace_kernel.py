"""The immature bank's two programs on the card's path: the plain versions
of the trace kernel (``frame_step._trace_core_torch``) and of the
activation kernel (``trace.activate_candidates_torch``) against the JAX
package's ``frame_step.trace_step`` and ``trace.activate_candidates_device``
on the same numpy-made bank and window, at ``preset("tiny")`` and at the
default shapes (2048 rows, 640x480, F = 10, 32 samples, the 4-point sweep),
with edge rows; the dispatch of ``frame_step._trace_core`` and
``trace.activate_candidates_device``; the wrappers' refusals; the slot
tables the kernels make, their expression replayed in torch ops with the
CPU's rounding rules (``table_replay``) against ``trace_slot_tables`` /
``activation_slot_tables`` bit for bit; the activation's launch layout; the
activation kernel's order replayed in torch (``chip_smoke.activate_replay``)
against the plain version; the build's hash of the headers; chip_smoke's
yardsticks (the replay of the plain trace, the ties, the bounds) on the
CPU; and, on a card, each CUDA kernel (``kernels/trace.py``) against its
plain version with chip_smoke's tie rule, bit for bit in a second launch,
the activation bit for bit its order's replay, and the kernels' tables bit
for bit the torch tables at 1, 3, 10 and 32 slots.

The JAX package is imported inside the tests that use it, so that the
card's machine, which has no JAX, runs the kernels' tests:
``python -m pytest --noconftest -m gpu tests/test_torch_trace_kernel.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
import table_replay as tr
from ldso_tpu_torch import frame_step
from ldso_tpu_torch import trace as ttrace
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.core.bank import Bank
from ldso_tpu_torch.core.window import PATTERN_OFFSETS
from ldso_tpu_torch.io import synthetic
from ldso_tpu_torch.kernels import cuda_build
from ldso_tpu_torch.kernels import pyramid as tpyr
from ldso_tpu_torch.kernels import trace as ktr
from ldso_tpu_torch.math import lie

GOOD, OOB, OUTLIER, SKIPPED = ttrace.GOOD, ttrace.OOB, ttrace.OUTLIER, ttrace.SKIPPED
# tests/test_torch_trace.py's allowance and tolerances: statuses are
# threshold decisions on float32 SSDs summed in another order (the JAX
# linspace is float64 under x64), so 2% of the rows may flip; the refined
# intervals and quality of rows GOOD on both sides within these. Quality is
# a ratio of two SSDs, the best of which can be small (~10): on 2048 rows a
# few exceed 1e-3 (1.7e-3 seen), so it is held on all but QUALITY_SPREAD of
# them
STATUS_AGREE, QUALITY_SPREAD = 0.98, 0.01
IDEPTH_RTOL, IDEPTH_ATOL, QUALITY_RTOL = 1e-3, 1e-4, 1e-3
# and the activation's: per-point sums over F·8 samples in another order,
# through 3 GN steps
ACT_IDEPTH_RTOL, ACT_IDEPTH_ATOL, ACT_SUM_RTOL, ACT_SUM_ATOL = 1e-3, 1e-4, 1e-3, 1e-2
N_EDGE = 12                    # edge rows at the end of the bank (see _bank)


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    """One intra-op thread while this file runs, as the other heavy files
    (six test processes share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(name: str, w: int, h: int, seed: int) -> dict:
    """Five frames of a forward arc: frames 0-3 are keyframes in four
    slots of the window (the others invalid), frame 4 is the new frame. A
    bank of the preset's capacity hosted in those four slots at pixels with
    gradient and their true inverse depth, with edge rows at its end. All
    numpy (float32, int32, bool)."""
    cfg = preset(name)
    F, N = cfg.shapes.max_frames, cfg.shapes.max_immature
    ds = synthetic.SyntheticDataset(w=w, h=h, n=5, seed=seed, supersample=1)
    ds.poses_w_c = synthetic.trajectory(5, "forward_arc", step=0.08)
    ds._cache = {}
    rng = np.random.default_rng(seed + 11)
    slots = [0, 3, 5, F - 1]
    frame_valid = np.zeros(F, bool)
    frame_valid[slots] = True
    T_eval = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    x = np.zeros((F, 8), np.float32)
    exposure = np.ones(F, np.float32)
    ab_abs, exposure_new = np.asarray([0.01, 0.4], np.float32), 1.02
    # frame k as its exposure and affine state render it: e^a exposure I + b
    gain = [exposure_new * np.exp(ab_abs[0])] * 5
    offset = [ab_abs[1]] * 5
    for k, s in enumerate(slots):
        T_eval[s] = ds.gt_pose_c_w(k).astype(np.float32)
        x[s, :6] = rng.normal(scale=2e-4, size=6)
        x[s, 6:] = [0.02 * (k - 1.5), 0.5 * (k - 1.5)]
        exposure[s] = 1.0 + 0.05 * (k - 1.5)
        gain[k], offset[k] = exposure[s] * np.exp(x[s, 6]), x[s, 7]
    imgs = [(gain[i] * ds.get_image(i)[0] + offset[i]).astype(np.float32) for i in range(5)]
    img3 = [tpyr.build_pyramid_torch(torch.from_numpy(im), 1)[0][0].numpy() for im in imgs]
    images = np.zeros((F, h, w, 3), np.float32)
    for k, s in enumerate(slots):
        images[s] = img3[k]
    T_all = lie.se3_mul(lie.se3_exp(torch.from_numpy(x[:, :6])),
                        torch.from_numpy(T_eval)).numpy()
    T_new_cw = ds.gt_pose_c_w(4).astype(np.float32)
    # the new frame's depth axis in host slot 0's frame: an inverse depth
    # of -3 / t_z puts a point of that host behind the new camera
    t_z = float((T_new_cw @ np.linalg.inv(T_all[slots[0]]))[2, 3])
    bank, idep = _bank(ds, imgs, slots, N, rng, -3.0 / t_z)
    return dict(name=name, cfg=cfg, intr=np.asarray(ds.intrinsics(), np.float32),
                img3_new=img3[4], images=images, frame_valid=frame_valid, T_eval=T_eval, x=x,
                exposure=exposure, T_all=T_all, bank=bank, idep=idep, T_new_cw=T_new_cw,
                ab_abs=ab_abs, exposure_new=exposure_new)


def _bank(ds, imgs, slots, N: int, rng, d_behind: float) -> dict:
    """N rows hosted in ``slots`` (frame k in slots[k] for k < 4): first
    traces (NaN idepth_max), intervals around the truth, unbounded far
    ends, invalid rows; then the N_EDGE edge rows (``d_behind``: an inverse
    depth behind the new camera for a row of host slots[0]). Returns the
    bank and each row's true inverse depth."""
    h, w = imgs[0].shape
    n = N - N_EDGE
    host = rng.integers(0, 4, size=n)
    uv = np.zeros((N, 2), np.float32)
    color = np.zeros((N, 8), np.float32)
    idep = np.zeros(N, np.float32)
    for k in range(4):
        gy, gx = np.gradient(imgs[k])
        g2 = gx ** 2 + gy ** 2
        d = ds.get_idepth(k)
        ok = (d > 1e-3) & (g2 > np.percentile(g2, 60))
        ok[:8] = ok[-8:] = False
        ok[:, :8] = ok[:, -8:] = False
        cand = np.argwhere(ok)
        rows = np.nonzero(host == k)[0]
        sel = cand[rng.choice(len(cand), size=len(rows), replace=False)]
        uv[rows] = np.stack([sel[:, 1], sel[:, 0]], -1)
        # integer pixels + integer pattern offsets: the pattern colors are pixels
        pu = (uv[rows][:, None, :] + PATTERN_OFFSETS[None]).astype(int)
        color[rows] = imgs[k][pu[..., 1], pu[..., 0]]
        idep[rows] = d[sel[:, 0], sel[:, 1]]
    host_slot = np.zeros(N, np.int32)
    host_slot[:n] = np.asarray(slots)[host]
    kind = rng.random(N)
    d_min = np.where(kind < 0.4, 0.0, idep * rng.uniform(0.8, 0.97, N)).astype(np.float32)
    d_max = np.where(kind < 0.4, np.nan, idep * rng.uniform(1.03, 1.3, N)).astype(np.float32)
    d_max[(kind > 0.85) & (kind < 0.95)] = 1e7            # unbounded, not NaN
    b = dict(valid=rng.random(N) > 0.08, host_slot=host_slot, uv=uv, color=color,
             weight=np.ones((N, 8), np.float32), idepth_min=d_min, idepth_max=d_max,
             quality=rng.uniform(2.0, 20.0, N).astype(np.float32),
             last_status=rng.choice([GOOD, GOOD, GOOD, OUTLIER, SKIPPED], N).astype(np.int32),
             outlier_count=rng.integers(0, 4, N).astype(np.int32),
             is_corner=rng.random(N) > 0.7)
    e = n                                                  # the edge rows
    src = np.nonzero(b["valid"][:n] & (host_slot[:n] == slots[0]))[0][:N_EDGE]
    for f in ("host_slot", "uv", "color"):
        b[f][e:] = b[f][src]
    b["valid"][e:] = True
    b["outlier_count"][e:] = 0
    b["idepth_min"][e:], b["idepth_max"][e:] = idep[src] * 0.9, idep[src] * 1.1
    b["idepth_min"][e], b["idepth_max"][e] = 0.0, np.nan              # never traced
    b["idepth_min"][e + 1], b["idepth_max"][e + 1] = idep[src[1]] * 0.5, 1e8  # unbounded
    b["idepth_min"][e + 2] = d_behind                                  # behind the camera
    b["idepth_min"][e + 3], b["idepth_max"][e + 3] = d_behind, d_behind * 1.1
    b["uv"][e + 4] = (-40.0, -40.0)                # every sample out of bounds
    # a segment shorter than the slack
    b["idepth_min"][e + 5], b["idepth_max"][e + 5] = idep[src[5]], idep[src[5]] * 1.00001
    b["valid"][e + 6] = False                      # invalid, with junk
    b["uv"][e + 6], b["idepth_min"][e + 6], b["idepth_max"][e + 6] = (5e3, -3e3), -1.0, 3.0
    # 7 strikes: a first trace of junk colors is an outlier (8, dropped);
    # one of its own colors takes the strike only if it is an outlier
    b["outlier_count"][e + 7: e + 9] = 7
    b["idepth_min"][e + 7: e + 9], b["idepth_max"][e + 7: e + 9] = 0.0, np.nan
    b["color"][e + 7] = rng.uniform(0, 255, 8)
    return b, idep


@pytest.fixture(scope="module")
def default_scene():
    return _scene("default", 640, 480, 0)


@pytest.fixture(scope="module")
def tiny_scene():
    return _scene("tiny", 320, 240, 1)


def _trace_args(s, device="cpu"):
    """``frame_step._trace_core``'s arguments from a scene."""
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    bank = Bank(**{f: as_t(v) for f, v in s["bank"].items()})
    return (as_t(s["img3_new"]), bank, as_t(s["T_eval"]), as_t(s["x"]), as_t(s["exposure"]),
            as_t(s["T_new_cw"]), as_t(s["ab_abs"]), s["exposure_new"], as_t(s["intr"]),
            s["cfg"])


def _act_call(s, device="cpu"):
    """``trace.activate_candidates_device``'s (arguments, keywords) from a
    scene whose bank rows were traced GOOD to intervals of +-3% around the
    truth (every 7th an OUTLIER, every 11th never traced)."""
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    b = dict(s["bank"])
    rows = np.arange(len(b["valid"]))
    b["last_status"] = np.where(rows % 7 == 3, OUTLIER, GOOD).astype(np.int32)
    b["idepth_min"] = (s["idep"] * 0.97).astype(np.float32)
    b["idepth_max"] = np.where(rows % 11 == 5, np.nan, s["idep"] * 1.03).astype(np.float32)
    bank = Bank(**{f: as_t(v) for f, v in b.items()})
    cfg = s["cfg"]
    return ((as_t(s["images"]), as_t(s["frame_valid"]), as_t(s["T_all"]), as_t(s["x"]),
             as_t(s["exposure"]), bank, as_t(s["intr"]), float(cfg.trace.min_quality)),
            dict(iters=3, huber_th=float(cfg.ba.huber_th)))


def _jax_trace(s):
    import jax.numpy as jnp

    from ldso_tpu import frame_step as jfs
    from ldso_tpu.config import preset as jpreset
    from ldso_tpu.core import bank as jbank

    jb = jbank.Bank(**{f: jnp.asarray(np.array(v)) for f, v in s["bank"].items()})
    out = jfs.trace_step(jnp.asarray(s["img3_new"]), jb, jnp.asarray(s["T_eval"]),
                         jnp.asarray(s["x"]), jnp.asarray(s["exposure"]),
                         jnp.asarray(s["T_new_cw"]), jnp.asarray(s["ab_abs"]),
                         np.float32(s["exposure_new"]), jnp.asarray(s["intr"]),
                         jpreset(s["name"]))
    return {f: np.array(getattr(out, f)) for f in Bank._fields}


def _assert_trace_close(a: dict, b: dict, valid):
    """The bank after a trace, two versions (dicts of numpy fields)."""
    st_a, st_b = a["last_status"][valid], b["last_status"][valid]
    assert (st_a == st_b).mean() >= STATUS_AGREE, (np.bincount(st_a, minlength=6),
                                                   np.bincount(st_b, minlength=6))
    assert (a["valid"] == b["valid"]).mean() >= STATUS_AGREE
    same = valid & (a["last_status"] == b["last_status"])
    np.testing.assert_array_equal(a["outlier_count"][same], b["outlier_count"][same])
    both = same & (a["last_status"] == GOOD)
    assert both.sum() > 0.1 * valid.sum()
    for f in ("idepth_min", "idepth_max"):
        np.testing.assert_allclose(a[f][both], b[f][both], rtol=IDEPTH_RTOL, atol=IDEPTH_ATOL)
    qa, qb = a["quality"][both], b["quality"][both]
    with np.errstate(invalid="ignore"):               # inf against inf
        q_rel = np.where(qa == qb, 0.0, np.abs(qa - qb) / np.abs(qb))
    assert (q_rel > QUALITY_RTOL).mean() <= QUALITY_SPREAD, np.sort(q_rel)[-5:]
    # rows that kept their interval kept it bit for bit
    kept = same & (a["last_status"] != GOOD)
    for f in ("idepth_min", "idepth_max"):
        np.testing.assert_array_equal(a[f][kept], b[f][kept])


def _plain_trace(s) -> dict:
    out = frame_step._trace_core_torch(*_trace_args(s))
    return {f: getattr(out, f).numpy() for f in Bank._fields}


@pytest.mark.parametrize("which", ["tiny", "default"])
def test_plain_trace_matches_jax(which, tiny_scene, default_scene):
    s = tiny_scene if which == "tiny" else default_scene
    if which == "default":
        assert (s["bank"]["uv"].shape[0], s["img3_new"].shape, s["images"].shape[0]) == (
            2048, (480, 640, 3), 10)
        assert (s["cfg"].shapes.epi_samples, s["cfg"].trace.sweep_pattern) == (32, 4)
    _assert_trace_close(_plain_trace(s), _jax_trace(s), s["bank"]["valid"])


def test_plain_trace_edge_rows(default_scene):
    s = default_scene
    t, j = _plain_trace(s), _jax_trace(s)
    e = s["bank"]["uv"].shape[0] - N_EDGE
    for out in (t, j):
        st = out["last_status"][e:]
        # a first trace and an unbounded far end search their segment
        assert st[0] not in (OOB, SKIPPED) and st[1] not in (OOB, SKIPPED)
        assert st[2] == OOB and st[3] == OOB and st[4] == OOB    # behind / all out of bounds
        assert not out["valid"][e + 2: e + 5].any()              # OOB drops the row
        assert st[5] == SKIPPED
        for f in ("valid", "idepth_min", "idepth_max", "quality", "last_status",
                  "outlier_count"):                              # invalid: untouched
            np.testing.assert_array_equal(out[f][e + 6], s["bank"][f][e + 6])
        assert st[7] == OUTLIER and out["outlier_count"][e + 7] == 8
        assert not out["valid"][e + 7]
        strike = int(st[8] == OUTLIER)
        assert out["outlier_count"][e + 8] == 7 + strike
        assert out["valid"][e + 8] == (not strike and st[8] != OOB)
    np.testing.assert_array_equal(t["last_status"][e:], j["last_status"][e:])


def test_plain_activation_matches_jax(default_scene):
    import jax.numpy as jnp

    from ldso_tpu import trace as jtrace
    from ldso_tpu.core import bank as jbank

    s = default_scene
    (args, kw) = _act_call(s)
    jb = jbank.Bank(**{f: jnp.asarray(v.numpy()) for f, v in args[5]._asdict().items()})
    a = jtrace.activate_candidates_device(
        *(jnp.asarray(t.numpy()) for t in args[:5]), jb, jnp.asarray(args[6].numpy()),
        args[7], **kw)
    b = ttrace.activate_candidates_torch(*args, **kw)
    hosts = np.unique(s["bank"]["host_slot"][np.asarray(a["can"])])
    assert len(hosts) == 4 and not s["frame_valid"].all()
    np.testing.assert_array_equal(b["can"].numpy(), np.asarray(a["can"]))
    np.testing.assert_array_equal(b["count"].numpy(), np.asarray(a["count"]))
    np.testing.assert_allclose(b["idepth"].numpy(), np.asarray(a["idepth"]),
                               rtol=ACT_IDEPTH_RTOL, atol=ACT_IDEPTH_ATOL)
    for k in ("H_dd", "energy"):
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), rtol=ACT_SUM_RTOL,
                                   atol=ACT_SUM_ATOL)


def test_dispatch_takes_the_plain_versions_for_cpu_tensors(tiny_scene):
    args = _trace_args(tiny_scene)
    out, ref = frame_step._trace_core(*args), frame_step._trace_core_torch(*args)
    for a, b in zip(out, ref):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)) if a.is_floating_point() \
            else torch.equal(a, b)
    call_args, kw = _act_call(tiny_scene)
    res, ref = (ttrace.activate_candidates_device(*call_args, **kw),
                ttrace.activate_candidates_torch(*call_args, **kw))
    assert res.keys() == ref.keys() == {"idepth", "H_dd", "energy", "count", "can"}
    for k in res:
        assert torch.equal(res[k], ref[k])
    meta = _trace_args(tiny_scene, device="meta")
    with pytest.raises(ValueError, match="no trace for device"):
        frame_step._trace_core(*meta)
    m_args, m_kw = _act_call(tiny_scene, device="meta")
    with pytest.raises(ValueError, match="no activation for device"):
        ttrace.activate_candidates_device(*m_args, **m_kw)


def test_wrappers_refuse_cpu_and_non_contiguous_tensors(tiny_scene):
    args = _trace_args(tiny_scene)
    img3, bank, T_eval, x, expo, T_new_cw, ab_abs, expo_new, intr, cfg = args
    kw = frame_step._trace_kw(cfg)

    def trace(bank=bank, T_eval=T_eval, x=x, expo=expo, **more):
        return ktr.trace_bank_cuda(img3, bank, T_eval, x, expo, T_new_cw, ab_abs, expo_new,
                                   intr, **dict(kw, **more))

    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trace()
    wide = torch.cat([bank.uv, bank.uv], 1)[:, :2]
    with pytest.raises(ValueError, match="uv is not contiguous"):
        trace(bank._replace(uv=wide))
    with pytest.raises(TypeError, match="host_slot is torch.int64"):
        trace(bank._replace(host_slot=bank.host_slot.long()))
    with pytest.raises(ValueError, match="samples"):
        trace(num_samples=65)
    with pytest.raises(ValueError, match="x is not contiguous"):
        trace(x=torch.cat([x, x], 1)[:, :8])
    with pytest.raises(ValueError, match="33 slots"):
        trace(T_eval=T_eval[[0] * 33], x=x[[0] * 33], expo=expo[[0] * 33])
    (w_img, fv, T_all, xa, ea, abank, aintr, min_q), akw = _act_call(tiny_scene)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ktr.activate_bank_cuda(w_img, fv, T_all, xa, ea, abank, aintr, min_q, **akw)
    with pytest.raises(ValueError, match="T_all is not contiguous"):
        ktr.activate_bank_cuda(w_img, fv, T_all.transpose(1, 2), xa, ea, abank, aintr, min_q,
                               **akw)
    with pytest.raises(ValueError, match="33 slots"):
        ktr.activate_bank_cuda(w_img[[0] * 33], fv[[0] * 33], T_all[[0] * 33], xa[[0] * 33],
                               ea[[0] * 33], abank, aintr, min_q, **akw)


def test_slot_tables_are_the_plain_versions_per_row_values(tiny_scene):
    # the kernel path's per-slot tables, gathered per row, are bit for bit
    # the values the plain versions compute per row
    img3, bank, T_eval, x, expo, T_new_cw, ab_abs, expo_new, intr, cfg = _trace_args(tiny_scene)
    T_hn, ab = frame_step.trace_slot_tables(T_eval, x, expo, T_new_cw, ab_abs, expo_new)
    hs = bank.host_slot.long()
    T_all = lie.se3_mul(lie.se3_exp(x[:, :6]), T_eval)
    assert torch.equal(T_hn[hs], (T_new_cw @ lie.se3_inverse(T_all))[hs])
    ea_h = expo[hs] * torch.exp(x[hs, 6])
    alpha = (expo_new * torch.exp(ab_abs[0])) / torch.clamp(ea_h, min=1e-12)
    assert torch.equal(ab[hs, 0], alpha)
    assert torch.equal(ab[hs, 1], ab_abs[1] - alpha * x[hs, 7])
    T_rel, a_t, b_t = ttrace.activation_slot_tables(T_all, x, expo)
    ea = expo * torch.exp(x[:, 6])
    a_p = ea[None, :] / torch.clamp(ea[hs], min=1e-12)[:, None]
    assert torch.equal(a_t.T[hs], a_p)
    assert torch.equal(b_t.T[hs], x[None, :, 7] - a_p * x[hs, 7][:, None])
    assert torch.allclose(T_rel[:, hs].transpose(0, 1),
                          torch.einsum("fij,pjk->pfik", T_all, lie.se3_inverse(T_all)[hs]),
                          atol=1e-6)


def _slot_state(F: int, angle: float, seed: int = 0, device="cpu") -> tuple:
    """``trace_slot_tables``' arguments for F slots made with numpy: poses
    with rotations of about ``angle`` rad in T_eval and x, affine states,
    exposures, a new frame's pose, affine and exposure."""
    rng = np.random.default_rng(seed)

    def pose(n):
        return lie.se3_exp(torch.as_tensor(np.concatenate(
            [rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * angle], 1), dtype=torch.float32))

    x = rng.normal(size=(F, 8)) * 0.1
    x[:, 3:6] = rng.normal(size=(F, 3)) * angle
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return (pose(F).to(device), as_t(x), as_t(1 + 0.1 * rng.random(F)), pose(1)[0].to(device),
            as_t(rng.normal(size=2) * 0.1), float(np.float32(1 + 0.1 * rng.random())))


@pytest.mark.parametrize("F", [1, 3, 10])
@pytest.mark.parametrize("angle", [1e-6, 1.0])
def test_trace_table_replay_is_bitwise(F, angle):
    # the trace kernel's table expression with the CPU's rounding rules
    # gives the CPU's trace_slot_tables bit for bit: the small-angle branch
    # (angle 1e-6) and the general one
    st = _slot_state(F, angle, seed=F)
    (T_hn, ab), (r_hn, r_ab) = frame_step.trace_slot_tables(*st), tr.trace_tables(
        *st, tr.cpu_rules(F))
    assert r_hn.shape == T_hn.shape == (F, 4, 4) and r_ab.shape == ab.shape == (F, 2)
    assert cs._bits_equal(r_hn, T_hn) and cs._bits_equal(r_ab, ab)
    small = bool((st[1][:, 3:6].square().sum(-1) < 1e-8).all())
    assert small == (angle < 1e-3)


@pytest.mark.parametrize("F", [1, 3, 10])
@pytest.mark.parametrize("angle", [1e-6, 1.0])
def test_activation_table_replay_is_bitwise(F, angle):
    # the activation kernel's table expression (each slot's inverse, then
    # each (target, host) product) with the CPU's rounding rules gives the
    # CPU's activation_slot_tables bit for bit
    T_eval, x, expo = _slot_state(F, angle, seed=F)[:3]
    T_all = lie.se3_mul(lie.se3_exp(x[:, :6]), T_eval)
    ref = ttrace.activation_slot_tables(T_all, x, expo)
    got = tr.activation_tables(T_all, x, expo, tr.cpu_rules(F))
    assert got[0].shape == (F, F, 4, 4) and got[1].shape == got[2].shape == (F, F)
    for a, b in zip(got, ref):
        assert cs._bits_equal(a, b)


@pytest.mark.parametrize("F", range(1, 33))
def test_activation_layout_covers_each_slot_once(F):
    # read off csrc/trace.cu: the activation's CTA (the C entry's launch: a
    # CTA a row) and each thread's (target slot, pattern point) (the
    # kernel's layout line); every target slot is on 8 lanes of one warp, a
    # lane a pattern point, and the slots follow the thread index, so their
    # sums are added in slot order
    import re

    text = open(ktr.SOURCE).read()
    entry = text[text.index('extern "C" int ldso_activate_bank('):]
    assert "activate_bank_kernel<<<N, threads, 0," in entry
    threads = eval(re.search(r"const int threads = (.*?);", entry).group(1).replace("/", "//"),
                   {"F": F})
    assert threads == 32 * -(-F // 4) <= 32 * ktr.MAX_SLOTS // 4
    kernel = text[text.index(") activate_bank_kernel("):]
    g, j, f = re.search(r"const int g = (.*?), j = (.*?), f = (.*?);", kernel).groups()
    tid = np.arange(threads)
    env = dict(tid=tid, lane=tid & 31)
    env["g"] = eval(g, env)
    slot, point = eval(f, env), eval(j, env)
    for s in range(F):
        on = np.nonzero(slot == s)[0]
        assert on.tolist() == list(range(8 * s, 8 * s + 8))    # one group of 8, in a warp
        assert point[on].tolist() == list(range(8))            # each pattern point once
    assert (slot >= F).sum() == threads - 8 * F
    assert (np.diff(slot) >= 0).all()


@pytest.mark.parametrize("which", ["tiny", "default"])
def test_activation_replay_matches_plain(which, tiny_scene, default_scene):
    # the activation kernel's order replayed in torch (the yardstick of its
    # bits on the card) against the plain version, which sums every slot
    # and point in one reduction: the decisions equal, the results within
    # chip_smoke's bounds but at a tie (a sample within TRACE_TIE_PX of the
    # border at the plain version's inverse depths)
    call = _act_call(tiny_scene if which == "tiny" else default_scene)
    rep = cs.activate_replay(call)
    det = {}
    ref = ttrace.activate_candidates_torch(*call[0], **call[1], details=det)
    assert torch.equal(rep["can"], ref["can"]) and int(ref["can"].sum()) > 100
    ok_f = cs.activation_slots(call, ref["can"])
    tie = torch.zeros_like(ref["can"])
    for uvn, _ in det["samples"]:
        tie |= (cs._near_border(uvn, call[0][0].shape[2], call[0][0].shape[1])
                & ok_f[..., None]).flatten(1).any(1)
    held = ((rep["count"] == ref["count"])
            & cs._close(rep["idepth"], ref["idepth"], cs.ACT_IDEPTH_RTOL, cs.ACT_IDEPTH_ATOL)
            & cs._close(rep["H_dd"], ref["H_dd"], cs.ACT_SUM_RTOL, cs.ACT_SUM_ATOL)
            & cs._close(rep["energy"], ref["energy"], cs.ACT_SUM_RTOL, cs.ACT_SUM_ATOL))
    assert not bool((~held & ~tie).any()) and int((~held).sum()) <= cs.ACT_MAX_TIES
    assert torch.equal(rep["idepth"][~ref["can"]], ref["idepth"][~ref["can"]])


@pytest.mark.parametrize("entry", ["ldso_trace_bank", "ldso_activate_bank"])
def test_argtypes_follow_the_c_entry(entry):
    # the ctypes binding's argument types are the C entry point's, one by
    # one (a pointer, an int, a float), read off csrc/trace.cu
    import ctypes
    import re

    text = open(ktr.SOURCE).read()
    params = re.search(rf'extern "C" int {entry}\((.*?)\)\s*\{{', text, re.S).group(1)
    kinds = [("p" if "*" in q else "f" if q.split()[0] == "float" else "i")
             for q in params.replace("\n", " ").split(",")]
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    want = [types[k] for k in kinds]
    got = ktr.TRACE_ARGTYPES if entry == "ldso_trace_bank" else ktr.ACTIVATE_ARGTYPES
    assert got == want


def test_build_name_follows_local_headers(tmp_path):
    # a kernel's library is named by its source, the local headers it
    # includes and the flags: an edited header gives another library
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("trace.cu", "lie.cuh"):
        (src / name).write_bytes(open(os.path.join(os.path.dirname(ktr.SOURCE), name),
                                      "rb").read())
    cu = str(src / "trace.cu")
    texts = cuda_build.source_texts(cu)
    assert len(texts) == 2 and texts[1] == (src / "lie.cuh").read_bytes()
    before = cuda_build.library_path(cu, (), ktr.NO_FMAD)
    assert before == cuda_build.library_path(ktr.SOURCE, (), ktr.NO_FMAD)
    (src / "lie.cuh").write_bytes(texts[1] + b"// edited\n")
    after = cuda_build.library_path(cu, (), ktr.NO_FMAD)
    assert after != before and os.path.basename(after).startswith("libldso_trace_")
    assert cuda_build.library_path(cu, (), ()) != after               # the flags count too
    # both sources that make slot tables include the one header
    from ldso_tpu_torch.kernels import ba as kba

    assert cuda_build.source_texts(kba.SOURCE)[1] == cuda_build.source_texts(ktr.SOURCE)[1]


def test_wrapper_imports_without_nvcc():
    # nothing is built at import: no nvcc on PATH, no CUDA_HOME
    code = ("import ldso_tpu_torch.kernels.trace as k, ldso_tpu_torch.frame_step, "
            "ldso_tpu_torch.kernels.cuda_build as b\n"
            "assert k.LAUNCHES_TRACE == k.LAUNCHES_ACTIVATE == 0\n"
            "try:\n    b.nvcc()\nexcept RuntimeError:\n    pass\n"
            "else:\n    raise SystemExit('nvcc found')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=os.path.join(root, "no-cuda-here"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _hypotheses_one_by_one(T, num):
    """``tracker.motion_hypotheses`` as it was written before its offsets
    became a table: each built on the device one entry at a time."""
    from ldso_tpu_torch import tracker

    xi = lie.se3_log(T.to(torch.float32))
    cands, deltas = [xi, 0.5 * xi, 2.0 * xi, torch.zeros_like(xi)], []
    for ax in range(3):
        for sgn in (1.0, -1.0):
            d = torch.zeros_like(xi)
            d[3 + ax] = sgn * 0.02
            deltas.append(d)
    for ax1 in range(3):
        for ax2 in range(ax1 + 1, 3):
            for s1 in (1.0, -1.0):
                for s2 in (1.0, -1.0):
                    d = torch.zeros_like(xi)
                    d[3 + ax1] = s1 * 0.02
                    d[3 + ax2] = s2 * 0.02
                    deltas.append(d)
    cands = (cands + [xi + d for d in deltas])[:num]
    cands += [xi] * (num - len(cands))
    assert tracker._hypothesis_deltas(xi.device).shape == (len(deltas), 6)
    return lie.se3_exp(torch.stack(cands))


@pytest.mark.parametrize("num", [27, 22, 5, 30])
def test_motion_hypotheses_from_the_offset_table(num):
    # the prediction's offsets come from a table made once per device; the
    # hypotheses are bit for bit those built one entry at a time
    from ldso_tpu_torch import tracker

    T = lie.se3_exp(torch.tensor([0.01, -0.02, 0.15, 0.003, -0.01, 0.002]))
    a, b = tracker.motion_hypotheses(T, num), _hypotheses_one_by_one(T, num)
    assert a.shape == (num, 4, 4)
    assert torch.equal(a, b)


def test_linspace_steps_and_sweep_count():
    for k in (1, 2, 32, 64):
        assert torch.equal(ktr.linspace_steps(k, torch.device("cpu")),
                           torch.linspace(0.0, 1.0, k))
    # one definition of the sweep set (trace.sweep_indices), packed for the
    # kernel 3 bits a pattern point
    assert [len(ttrace.sweep_indices(p)) for p in (0, 1, 2, 3, 4, 5, 7, 8, 9)] == [
        1, 1, 2, 3, 4, 3, 3, 8, 8]
    assert ttrace.sweep_indices(4) == (0, 3, 5, 7)
    for p in (1, 2, 3, 4, 8):
        word, n = ktr.sweep_word(p)
        assert tuple((word >> (3 * s)) & 7 for s in range(n)) == ttrace.sweep_indices(p)


@pytest.mark.parametrize("which", ["tiny", "default"])
def test_chip_smoke_replay_is_the_plain_trace(which, tiny_scene, default_scene):
    # check_trace's yardsticks on the CPU: the details the plain trace keeps
    # are its own decisions (bit for bit), few rows are ties, the bound
    # counts bytes
    s = tiny_scene if which == "tiny" else default_scene
    args = _trace_args(s)
    plain = frame_step._trace_core_torch(*args)
    kept, rep = cs.trace_details(args)
    valid = args[1].valid
    for f in plain._fields:
        assert cs._bits_equal(getattr(kept, f), getattr(plain, f)), f
    assert torch.equal(rep["status"][valid], plain.last_status[valid])
    assert torch.equal(rep["quality"][valid].nan_to_num(7.0), plain.quality[valid].nan_to_num(7.0))
    assert len(rep["positions"]) == len(rep["raw_steps"]) + 1 == args[-1].trace.gn_iterations + 1
    ties = cs.trace_ties(rep, valid)
    assert int(ties.sum()) <= 0.02 * int(valid.sum())
    ms, by, n_bytes, flops = cs.trace_bound_ms(args, rep)
    n, n_valid = args[1].uv.shape[0], int(valid.sum())
    # every output written, every row's fields read as far as the trace needs them
    assert by == "bytes" and n_bytes > 21 * n + 57 * n_valid + 21 * (n - n_valid)
    assert flops > 0 and ms > 0


def test_chip_smoke_activation_bound_and_positions(tiny_scene):
    call = _act_call(tiny_scene)
    args, kw = call
    det = {}
    out = ttrace.activate_candidates_torch(*args, **kw, details=det)
    assert torch.equal(out["idepth"], ttrace.activate_candidates_torch(*args, **kw)["idepth"])
    assert len(det["samples"]) == kw["iters"] + 1
    uvn, inb = det["samples"][-1]
    # the samples that count are the plain version's count, on the slots
    # activation_slots names
    assert torch.equal(inb.flatten(1).sum(1).float(), out["count"])
    assert not bool((inb & ~cs.activation_slots(call, out["can"])[..., None]).any())
    det["can"] = out["can"]
    ms, by, n_bytes, flops = cs.activate_bound_ms(call, det)
    n, n_can = args[5].uv.shape[0], int(out["can"].sum())
    assert n_bytes > 18 * n + 44 * n_can and flops > 0 and ms > 0


# ---- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["tiny", "default"])
def test_cuda_trace_matches_plain(cuda, which, tiny_scene, default_scene):
    s = tiny_scene if which == "tiny" else default_scene
    args = _trace_args(s, device=cuda)
    before = ktr.LAUNCHES_TRACE
    # the tie rule, a bitwise repeat, the kernel's tables (a third launch)
    rec = cs.check_trace(f"{which} scene", args)
    assert ktr.LAUNCHES_TRACE == before + 3
    assert rec["table"]["entries"] == 0
    assert rec["valid"] > 0 and rec["status"][GOOD] > 0


@pytest.mark.gpu
def test_cuda_trace_edge_rows_and_bank_update(cuda, default_scene):
    s = default_scene
    args = _trace_args(s, device=cuda)
    before = ktr.LAUNCHES_TRACE
    out = frame_step._trace_core(*args)                 # the dispatcher: one launch
    torch.cuda.synchronize()
    assert ktr.LAUNCHES_TRACE == before + 1
    plain = frame_step._trace_core_torch(*args)
    e = s["bank"]["uv"].shape[0] - N_EDGE
    for f in ("valid", "last_status", "outlier_count"):
        assert torch.equal(getattr(out, f)[e:].cpu(), getattr(plain, f)[e:].cpu()), f
    for f in ("weight", "is_corner", "uv", "color", "host_slot"):
        assert getattr(out, f) is args[1]._asdict()[f]     # untouched fields pass through
    # the input bank is not written
    assert torch.equal(args[1].idepth_max.isnan().cpu(), torch.from_numpy(
        np.isnan(s["bank"]["idepth_max"])))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["tiny", "default"])
def test_cuda_activation_matches_plain(cuda, which, tiny_scene, default_scene):
    s = tiny_scene if which == "tiny" else default_scene
    call = _act_call(s, device=cuda)
    before = ktr.LAUNCHES_ACTIVATE
    # ties, a bitwise repeat, bit for bit the replay of its order, the
    # kernel's tables (a third launch)
    rec = cs.check_activate(f"{which} scene", call)
    assert ktr.LAUNCHES_ACTIVATE == before + 3
    assert rec["candidates"] > 0 and rec["table"]["entries"] == 0
    res = ttrace.activate_candidates_device(*call[0], **call[1])
    torch.cuda.synchronize()
    assert ktr.LAUNCHES_ACTIVATE == before + 4
    assert res["can"].dtype == torch.bool and res["count"].dtype == torch.float32


def _small_bank(n: int, device) -> Bank:
    """n invalid rows: the tables' launches need a bank, not its rows."""
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    return Bank(valid=z(n, dt=torch.bool), host_slot=z(n, dt=torch.int32), uv=z(n, 2),
                color=z(n, 8), weight=z(n, 8), idepth_min=z(n), idepth_max=z(n), quality=z(n),
                last_status=z(n, dt=torch.int32), outlier_count=z(n, dt=torch.int32),
                is_corner=z(n, dt=torch.bool))


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 3, 10, 32])
@pytest.mark.parametrize("angle", [1e-6, 1.0])
def test_cuda_trace_tables_equal_plain(cuda, F, angle):
    # the slot tables the trace kernel makes equal trace_slot_tables on the
    # card bit for bit: the small-angle branch and the general one, a batch
    # of one matrix and of many
    T_eval, x, expo, T_new_cw, ab_abs, expo_new = _slot_state(F, angle, seed=F, device=cuda)
    intr = torch.tensor([50.0, 50.0, 8.0, 8.0], device=cuda)
    args = (torch.zeros((16, 16, 3), device=cuda), _small_bank(4, cuda), T_eval, x, expo,
            T_new_cw, ab_abs, expo_new, intr, preset("tiny"))
    rec = cs.trace_table_compare(args)
    assert rec["entries"] == 0, rec


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 3, 10, 32])
@pytest.mark.parametrize("angle", [1e-6, 1.0])
def test_cuda_activation_tables_equal_plain(cuda, F, angle):
    # the relative poses and affine transfers the activation kernel makes
    # equal activation_slot_tables on the card bit for bit
    T_eval, x, expo = _slot_state(F, angle, seed=F, device=cuda)[:3]
    T_all = lie.se3_mul(lie.se3_exp(x[:, :6]), T_eval)
    intr = torch.tensor([50.0, 50.0, 8.0, 8.0], device=cuda)
    call = ((torch.zeros((F, 16, 16, 3), device=cuda), torch.ones(F, dtype=torch.bool,
                                                                   device=cuda),
             T_all, x, expo, _small_bank(4, cuda), intr, 3.0), dict(iters=3, huber_th=9.0))
    rec = cs.activation_table_compare(call)
    assert rec["entries"] == 0, rec
