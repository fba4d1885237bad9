"""lifecycle.py of the port against the JAX package: keyframe activation
(GN + gates + spacing + scatter) and the candidate reseed patch, plus the
bank operations and the seed program they consume."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu import lifecycle as jlife
from ldso_tpu import system as jsys
from ldso_tpu import trace as jtrace
from ldso_tpu.config import preset
from ldso_tpu.core import bank as jbank
from ldso_tpu.kernels import pyramid as jpyr
from ldso_tpu_torch import convert
from ldso_tpu_torch import lifecycle as tlife
from ldso_tpu_torch import system as tsys
from ldso_tpu_torch.core import bank as tbank
from ldso_tpu_torch.kernels import pyramid as tpyr
from test_ba import make_synthetic_window

_BASE = preset("tiny")
CFG = _BASE.replace(selector=dataclasses.replace(_BASE.selector, corner_fraction=0.0))


@pytest.fixture(scope="module")
def state():
    """A 3-keyframe window (100 active points hosted by slot 0) and a bank
    of 150 traced candidates hosted by slots 0 and 1, intervals around
    the ground truth (host-1 candidates share host 0's depth map, so
    their gates differ, which the comparison covers too)."""
    win, ds = make_synthetic_window(n_frames=3, n_points=100, idepth_noise=0.02)
    w = {f: np.array(getattr(win, f)) for f in win._fields}
    rng = np.random.default_rng(3)
    idep = ds.get_idepth(0)
    g2 = w["images"][0, ..., 1] ** 2 + w["images"][0, ..., 2] ** 2
    ok = (idep > 1e-3) & (g2 > np.percentile(g2, 50))
    ok[:10] = ok[-10:] = False
    ok[:, :10] = ok[:, -10:] = False
    cand = np.argwhere(ok)
    sel = cand[rng.choice(len(cand), size=150, replace=False)]
    b = {f: np.array(v) for f, v in jbank.empty_bank(CFG.shapes.max_immature)._asdict().items()}
    n = 150
    uv = np.stack([sel[:, 1], sel[:, 0]], -1).astype(np.float32)
    d = idep[sel[:, 0], sel[:, 1]]
    b["valid"][:n] = True
    b["host_slot"][:n] = np.where(np.arange(n) % 3 == 0, 1, 0)
    b["uv"][:n] = uv
    pu = (uv[:, None, :] + np.asarray(tsys.pattern("cpu"))[None]).astype(int)
    b["color"][:n] = w["images"][0][pu[..., 1], pu[..., 0], 0]
    b["idepth_min"][:n] = d * 0.95
    b["idepth_max"][:n] = d * 1.05
    b["quality"][:n] = rng.uniform(2.0, 30.0, n)
    b["last_status"][:n] = np.where(rng.random(n) < 0.85, jtrace.GOOD, jtrace.OUTLIER)
    b["is_corner"][:n] = rng.random(n) < 0.2
    return w, b, ds


@pytest.mark.parametrize("mad_px", [3.0, 0.4])
def test_kf_activate(state, mad_px):
    w, b, ds = state
    intr = ds.intrinsics()
    jw = jsys.Window(**{f: jnp.asarray(v) for f, v in w.items()})
    jb = jbank.Bank(**{f: jnp.asarray(v) for f, v in b.items()})
    wj, dj, sj = jlife.kf_activate(jw, jb, jnp.asarray(intr), jnp.int32(2),
                                   jnp.float32(mad_px), CFG)
    wt, dt, st = tlife.kf_activate(convert.from_numpy("window", w, device="cpu"),
                                   convert.from_numpy("bank", b, device="cpu"),
                                   torch.tensor(intr), 2, mad_px, CFG)
    # gates, spacing cells, ranks and slots are discrete: exact
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[tlife.ST_N_ACT] > 10
    for f in ("p_valid", "p_host", "res_mask", "p_uv", "p_color", "p_weight"):
        np.testing.assert_array_equal(getattr(wt, f).numpy(), np.asarray(getattr(wj, f)), f)
    # activation GN idepths (3 steps, f32 sums in another order)
    np.testing.assert_allclose(wt.p_idepth.numpy(), np.asarray(wj.p_idepth), rtol=1e-3,
                               atol=1e-4)


@pytest.fixture(scope="module")
def seeds(state):
    w, _, _ = state
    img = w["images"][1, ..., 0]
    pj, _ = jpyr.build_pyramid_xla(jnp.asarray(img), 3)
    pt, _ = tpyr.build_pyramid_torch(torch.tensor(img), 3)
    sj = jsys._seed_program(pj[0], pj[1], pj[2], CFG, 1)
    st = tsys._seed_program(pt[0], pt[1], pt[2], CFG, 1)
    return sj, st


def test_seed_program(seeds):
    sj, st = seeds
    np.testing.assert_array_equal(st["sel_uv"].numpy(), np.asarray(sj["sel_uv"]))
    np.testing.assert_array_equal(st["sel_valid"].numpy(), np.asarray(sj["sel_valid"]))
    # bilinear pattern samples at integer pixels
    np.testing.assert_allclose(st["sel_color"].numpy(), np.asarray(sj["sel_color"]),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(st["sel_weight"].numpy(), np.asarray(sj["sel_weight"]),
                               rtol=1e-6, atol=1e-6)


def test_seed_patch_and_bank_ops(state, seeds):
    _, b, _ = state
    sj, st = seeds
    dying = np.zeros(CFG.shapes.max_frames, bool)
    dying[1] = True
    jb = jbank.Bank(**{f: jnp.asarray(v) for f, v in b.items()})
    tb = convert.from_numpy("bank", b, device="cpu")
    pj = jlife.compute_seed_patch(jb, sj, jnp.int32(2), jnp.asarray(dying), CFG)
    pt = tlife.compute_seed_patch(tb, st, 2, torch.tensor(dying), CFG)
    for x, y in zip(pt, pj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-4)
    bj = jbank.apply_patch(jb, *pj[:5], jnp.int32(2), pj[5])
    bt = tbank.apply_patch(tb, *pt[:5], 2, pt[5])
    drop = np.arange(CFG.shapes.max_immature) % 5 == 0
    bj = jbank.drop_hosted(jbank.drop_rows(bj, jnp.asarray(drop)), jnp.asarray(dying[::-1].copy()))
    bt = tbank.drop_hosted(tbank.drop_rows(bt, torch.tensor(drop)), torch.tensor(dying[::-1].copy()))
    out_j = {f: np.asarray(v) for f, v in bj._asdict().items()}
    for f, v in convert.to_numpy(bt).items():
        np.testing.assert_allclose(v, out_j[f], rtol=1e-6, atol=1e-4, equal_nan=True, err_msg=f)
    assert convert.to_numpy(bt)["valid"].sum() > 150
