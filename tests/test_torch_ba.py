"""ba/ of the port against the JAX package on one tiny window (3 keyframes,
100 points, from tests/test_ba.py's synthetic window): the assembled
blocks in both modes, the damped Schur solve, the energy-gated λ ladder
of the BA loop, and the marginalization folds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu.ba import marginal as jmarg
from ldso_tpu.ba import residuals as jres
from ldso_tpu.ba import solve as jsolve
from ldso_tpu.config import preset
from ldso_tpu.core import window as jwin
from ldso_tpu_torch import convert
from ldso_tpu_torch.ba import marginal as tmarg
from ldso_tpu_torch.ba import residuals as tres
from ldso_tpu_torch.ba import solve as tsolve
from ldso_tpu_torch.core import window as twin
from test_ba import make_synthetic_window

CFG = preset("tiny")
HUB, OSUM = CFG.ba.huber_th, CFG.ba.outlier_th_sum_component


def _np(win):
    return {f: np.array(getattr(win, f)) for f in win._fields}


@pytest.fixture(scope="module")
def wins():
    """(JAX window, its numpy fields) at a state moved off the FEJ point:
    noisy poses/idepths, plus a current-vs-FEJ delta in pose, affine,
    intrinsics and idepth so the FEJ transport of mode="fej" is exercised."""
    win, _ = make_synthetic_window(n_frames=3, n_points=100, idepth_noise=0.05,
                                   pose_noise=0.002)
    a = _np(win)
    rng = np.random.default_rng(11)
    a["x"][1:3, :6] += (rng.normal(size=(2, 6)) * 1e-3).astype(np.float32)
    a["x"][1:3, 6:8] += np.asarray([0.01, 0.5], np.float32)
    a["c"] = a["c"] + np.asarray([0.3, -0.3, 0.2, 0.1], np.float32)
    a["p_idepth"] = (a["p_idepth"] * (1 + 0.01 * rng.normal(size=a["p_idepth"].shape))
                     ).astype(np.float32)
    return jwin.Window(**{f: jnp.asarray(v) for f, v in a.items()}), a


def _close(t, j, rtol=1e-3, rel_atol=1e-5):
    """Sums over ~1000 float32 residual rows in another order: relative
    1e-3, with an absolute floor of 1e-5 of the array's largest entry."""
    j = np.asarray(j, np.float64)
    t = np.asarray(t, np.float64)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rel_atol * max(np.abs(j).max(), 1e-30))


def test_precompute_pairs(wins):
    jw, a = wins
    pj = jres.precompute_pairs(jw)
    pt = tres.precompute_pairs(convert.from_numpy("window", a, device="cpu"))
    for f in pj._fields:
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["active", "fej"])
def test_assemble_blocks(wins, mode):
    jw, a = wins
    sj = jres.assemble(jw, huber_th=HUB, outlier_sum=OSUM, mode=mode)
    st = tres.assemble(convert.from_numpy("window", a, device="cpu"), huber_th=HUB,
                       outlier_sum=OSUM, mode=mode)
    # masks and counts are decisions on identical projections: exact
    for f in ("valid_pair", "oob_pair", "num_res"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))
    assert int(st.num_res) > 500
    for f in ("H", "b", "H_xd", "H_dd", "b_d", "e_pair"):
        _close(getattr(st, f).numpy(), getattr(sj, f))
    np.testing.assert_allclose(float(st.energy), float(sj.energy), rtol=1e-4)


def test_energy_only(wins):
    jw, a = wins
    ej, nj = jres.energy_only(jw, huber_th=HUB, outlier_sum=OSUM)
    et, nt = tres.energy_only(convert.from_numpy("window", a, device="cpu"), huber_th=HUB,
                              outlier_sum=OSUM)
    assert int(nt) == int(nj)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-4)


def test_solver_inputs(wins):
    jw, a = wins
    tw = convert.from_numpy("window", a, device="cpu")
    np.testing.assert_allclose(tsolve.scale_nullspace(tw, 0).numpy(),
                               np.asarray(jsolve.scale_nullspace(jw, 0)), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tsolve.prior_offset(tw).numpy(),
                                  np.asarray(jsolve.prior_offset(jw)))
    np.testing.assert_array_equal(tsolve.prior_diag(tw.frame_valid, CFG).numpy(),
                                  np.asarray(jsolve._prior_diag_traced(jw.frame_valid, CFG)))


@pytest.mark.parametrize("lam", [1e-5, 1e-1])
def test_solve_core(wins, lam):
    """Both solves on the SAME system (the JAX assembly)."""
    jw, a = wins
    sj = jres.assemble(jw, huber_th=HUB, outlier_sum=OSUM)
    F = jw.num_frames
    D = 8 * F + 4
    rng = np.random.default_rng(5)
    A = rng.normal(size=(D, D)) * 0.1
    HM = (A @ A.T).astype(np.float32)
    bM = (rng.normal(size=D) * 0.1).astype(np.float32)
    s_vec = jsolve.scale_vector(F, CFG.scales)
    fixed = jsolve.fix_mask(F, 0)
    prior = np.asarray(jsolve.prior_diag(np.asarray(jw.frame_valid), CFG))
    N = np.asarray(jsolve.scale_nullspace(jw, 0))
    delta = np.asarray(jwin.state_delta(jw))
    off = np.asarray(jsolve.prior_offset(jw))
    sys_np = [np.array(getattr(sj, f)) for f in ("H", "b", "H_xd", "H_dd", "b_d")]
    common = [HM, bM, delta, prior, s_vec, fixed, N]
    dxj, ddj = jsolve._solve_core(*map(jnp.asarray, sys_np + common), jnp.float32(lam),
                                  jw.p_valid, prior_off=jnp.asarray(off))
    dxt, ddt = tsolve._solve_core(*[torch.tensor(v) for v in sys_np + common], lam,
                                  torch.tensor(a["p_valid"]), prior_off=torch.tensor(off))
    # f32 LU solves of a Jacobi-preconditioned (8F+4)² system
    _close(dxt.numpy(), dxj, rtol=1e-3, rel_atol=1e-4)
    _close(ddt.numpy(), ddj, rtol=1e-3, rel_atol=1e-4)


def _jax_ladder(jw, HM, bM, anchor=0):
    """The reference's _ba_loop_device ladder spelled out with the JAX
    package's own pieces, recording λ after every iteration."""
    cfg = CFG
    F = jw.num_frames
    prior_d = jsolve._prior_diag_traced(jw.frame_valid, cfg)
    s_vec = jnp.asarray(jsolve.scale_vector(F, cfg.scales))
    fixed = jnp.asarray(jsolve.fix_mask(F, anchor))
    N = jsolve.scale_nullspace(jw, anchor)
    off = jsolve.prior_offset(jw)
    HM, bM = jnp.asarray(HM, jnp.float32), jnp.asarray(bM, jnp.float32)

    def total(E, w):
        d = jwin.state_delta(w)
        da = d + off
        return float(E + d @ bM + 0.5 * d @ (HM @ d) + 0.5 * jnp.sum(prior_d * da * da))

    sys = jres.assemble(jw, huber_th=HUB, outlier_sum=OSUM)
    E = total(sys.energy, jw)
    lam, ladder, w = np.float32(cfg.ba.lambda_initial), [], jw
    for it in range(cfg.ba.max_iterations):
        dx, dd = jsolve._solve_core(sys.H, sys.b, sys.H_xd, sys.H_dd, sys.b_d, HM, bM,
                                    jwin.state_delta(w), prior_d, s_vec, fixed, N,
                                    jnp.float32(lam), jw.p_valid, prior_off=off)
        w_try = jsolve.apply_step(w, dx, cfg.scales.idepth * dd)
        sys_try = jres.assemble(w_try, huber_th=HUB, outlier_sum=OSUM)
        E_try = total(sys_try.energy, w_try)
        ok = np.isfinite(E_try) and E_try < E
        if ok:
            w, sys, E = w_try, sys_try, E_try
            lam = np.float32(max(lam * np.float32(0.25), np.float32(1e-7)))
        else:
            lam = np.float32(lam * np.float32(4.0))
        ladder.append(float(lam))
        if (ok and float(jnp.max(jnp.abs(dx))) < cfg.ba.step_break_th
                and it + 1 >= cfg.ba.min_iterations) or lam > 1e2:
            break
    return ladder


@pytest.mark.parametrize("prior", [False, True])
def test_run_ba_ladder_and_result(wins, prior):
    jw, a = wins
    D = CFG.shapes.state_dim
    HM, bM = jmarg.empty_prior(D)
    if prior:
        rng = np.random.default_rng(2)
        A = rng.normal(size=(D, D))
        HM, bM = 10.0 * (A @ A.T) / D, rng.normal(size=D)
    jw2, sj = jsolve.run_ba(jw, HM, bM, CFG, anchor_slot=0)
    tw2, stt = tsolve.run_ba(convert.from_numpy("window", a, device="cpu"), HM, bM, CFG,
                             anchor_slot=0)
    # the same accept/reject sequence: the λ after every iteration, and the
    # number of accepted steps of the reference's fused device loop
    assert stt.lam_ladder == _jax_ladder(jw, HM, bM)
    assert stt.iterations == sj.iterations
    assert stt.num_residuals == sj.num_residuals
    np.testing.assert_allclose(stt.energy_initial, sj.energy_initial, rtol=1e-4)
    np.testing.assert_allclose(stt.energy_final, sj.energy_final, rtol=1e-3)
    # a few LM steps in f32 from the same state
    np.testing.assert_allclose(tw2.x.numpy(), np.asarray(jw2.x), atol=2e-4)
    np.testing.assert_allclose(tw2.c.numpy(), np.asarray(jw2.c), rtol=1e-4)
    np.testing.assert_allclose(tw2.p_idepth.numpy(), np.asarray(jw2.p_idepth), rtol=2e-3,
                               atol=1e-4)
    np.testing.assert_allclose(stt.poses, sj.poses, atol=2e-4)
    for f in ("p_valid", "res_mask", "junk", "valid_pair"):
        np.testing.assert_array_equal(getattr(stt, f), getattr(sj, f))
    np.testing.assert_array_equal(tw2.p_valid.numpy(), np.asarray(jw2.p_valid))


def test_marginalize_points_and_frame(wins):
    jw, a = wins
    D = CFG.shapes.state_dim
    HM, bM = jmarg.empty_prior(D)
    mask = np.zeros(a["p_valid"].shape[0], bool)
    mask[:40] = True
    Hj, bj = jmarg.marginalize_points(jw, mask, HM, bM, CFG)
    Ht, bt = tmarg.marginalize_points(convert.from_numpy("window", a, device="cpu"), mask,
                                      HM, bM, CFG)
    # the f32 FEJ assembly of 40 points, folded in f64
    _close(Ht, Hj, rtol=2e-3, rel_atol=1e-5)
    _close(bt, bj, rtol=2e-3, rel_atol=1e-5)
    # the frame fold is the same float64 numpy on both sides
    fj = jmarg.marginalize_frame(1, Hj, bj, np.full(8, 2.0), np.full(8, 0.1))
    ft = tmarg.marginalize_frame(1, Hj, bj, np.full(8, 2.0), np.full(8, 0.1))
    for x, y in zip(ft, fj):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)


def test_window_ops(wins):
    """insert/remove frame, add/drop points, connect, activate_points_device."""
    jw, a = wins
    tw = convert.from_numpy("window", a, device="cpu")
    rng = np.random.default_rng(9)
    slots = np.full(20, CFG.shapes.max_points, np.int32)
    slots[:12] = np.arange(150, 162)
    uv = (rng.random((20, 2)) * [200, 150] + 20).astype(np.float32)
    idep = (rng.random(20) + 0.2).astype(np.float32)
    host = np.full(20, 1, np.int32)
    host[::2] = 0
    j_ops = jwin.activate_points_device(jw, jnp.asarray(slots), jnp.asarray(host),
                                        jnp.asarray(uv), jnp.asarray(idep))
    t_ops = twin.activate_points_device(tw, torch.tensor(slots), torch.tensor(host),
                                        torch.tensor(uv), torch.tensor(idep))
    j_ops = jwin.connect_new_frame(jwin.remove_frame(jwin.drop_points(j_ops, np.arange(256) % 7 == 0), 2), 1)
    t_ops = twin.connect_new_frame(twin.remove_frame(twin.drop_points(t_ops, np.arange(256) % 7 == 0), 2), 1)
    j_ops = jwin.add_points(j_ops, slots[::-1].copy(), 1, uv, uv.repeat(4, 1), uv.repeat(4, 1), idep)
    t_ops = twin.add_points(t_ops, slots[::-1].copy(), 1, uv, uv.repeat(4, 1), uv.repeat(4, 1), idep)
    for f in jwin.Window._fields:
        # bilinear colors/weights in f32: 1e-4 of the intensity scale
        np.testing.assert_allclose(getattr(t_ops, f).numpy(), np.asarray(getattr(j_ops, f)),
                                   rtol=1e-6, atol=1e-4, err_msg=f)
