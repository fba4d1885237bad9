"""trace.py of the port against the JAX package: the epipolar sweep
(status and interval), the single-host and per-point-host activation GN,
and the self-gating activation entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu import trace as jtrace
from ldso_tpu.config import preset
from ldso_tpu.core import bank as jbank
from ldso_tpu.kernels import pyramid as jpyr
from ldso_tpu.math import lie as jl
from ldso_tpu_torch import convert
from ldso_tpu_torch import trace as ttrace
from ldso_tpu_torch.core.window import PATTERN_OFFSETS
from ldso_tpu_torch.io import synthetic
from ldso_tpu_torch.kernels import pyramid as tpyr

CFG = preset("tiny")


@pytest.fixture(scope="module")
def scene():
    """Three frames 0.15 apart; 300 GT-depth points on frame 0 with their
    pattern colors; both packages' level-0 stacks."""
    n = 3
    ds = synthetic.SyntheticDataset(w=256, h=192, n=n, seed=3, supersample=1)
    ds.poses_w_c = synthetic.trajectory(n, "forward_arc", step=0.15)
    ds._cache = {}
    imgs = [ds.get_image(i)[0].astype(np.float32) for i in range(n)]
    rng = np.random.default_rng(4)
    idep = ds.get_idepth(0)
    gy, gx = np.gradient(imgs[0])
    g2 = gx ** 2 + gy ** 2
    ok = (idep > 1e-3) & (g2 > np.percentile(g2, 60))
    ok[:8] = ok[-8:] = False
    ok[:, :8] = ok[:, -8:] = False
    cand = np.argwhere(ok)
    sel = cand[rng.choice(len(cand), size=300, replace=False)]
    uv = np.stack([sel[:, 1], sel[:, 0]], -1).astype(np.float32)
    # integer pixels + integer pattern offsets: bilinear = pixel values
    pu = (uv[:, None, :] + PATTERN_OFFSETS[None]).astype(int)
    colors = imgs[0][pu[..., 1], pu[..., 0]]
    j_img3 = [np.asarray(jpyr.build_pyramid_xla(jnp.asarray(im), 1)[0][0]) for im in imgs]
    t_img3 = [tpyr.build_pyramid_torch(torch.from_numpy(im), 1)[0][0] for im in imgs]
    T_rel = np.stack([(ds.gt_pose_c_w(i) @ ds.poses_w_c[0]).astype(np.float32)
                      for i in range(n)])
    return dict(ds=ds, intr=ds.intrinsics(), uv=uv, colors=colors.astype(np.float32),
                idep=idep[sel[:, 0], sel[:, 1]].astype(np.float32),
                valid=rng.random(300) > 0.1, j_img3=j_img3, t_img3=t_img3, T_rel=T_rel)


def _trace_both(s, T_hn, dmin, dmax, ab):
    kw = dict(num_samples=CFG.shapes.epi_samples, min_quality=CFG.trace.min_quality,
              sweep_pattern=CFG.trace.sweep_pattern)
    a = jtrace.trace_points(jnp.asarray(s["j_img3"][1]), jnp.asarray(s["uv"]),
                            jnp.asarray(s["colors"]), jnp.asarray(dmin), jnp.asarray(dmax),
                            jnp.asarray(s["valid"]), jnp.asarray(T_hn), jnp.asarray(ab),
                            jnp.asarray(s["intr"]), **kw)
    b = ttrace.trace_points(s["t_img3"][1], torch.from_numpy(s["uv"]),
                            torch.from_numpy(s["colors"]), torch.from_numpy(dmin),
                            torch.from_numpy(dmax), torch.from_numpy(s["valid"]),
                            torch.from_numpy(T_hn), torch.from_numpy(ab),
                            torch.from_numpy(s["intr"]), **kw)
    return a, b


@pytest.mark.parametrize("case", ["bounded", "unbounded", "pure_rotation"])
def test_trace_points_status_and_interval(scene, case):
    n = scene["uv"].shape[0]
    dmin = np.full(n, 0.05, np.float32)
    dmax = np.full(n, 3.0 if case == "bounded" else 1e8, np.float32)
    T_hn = scene["T_rel"][1]
    if case == "pure_rotation":
        T_hn = np.array(jl.se3_exp(jnp.asarray([0, 0, 0, 0.0, 0.02, 0.0], jnp.float32)))
    a, b = _trace_both(scene, T_hn, dmin, dmax, np.asarray([1.0, 0.0], np.float32))
    st_a, st_b = np.asarray(a.status), b.status.numpy()
    # statuses are threshold decisions on f32 SSDs summed in another order
    # (the JAX linspace is f64 under x64): allow 2% of points to flip
    assert (st_a == st_b).mean() >= 0.98, (np.bincount(st_a, minlength=6),
                                            np.bincount(st_b, minlength=6))
    both = (st_a == jtrace.GOOD) & (st_b == jtrace.GOOD)
    if case != "pure_rotation":
        assert both.mean() > 0.3
    # sub-pixel refined intervals of points GOOD on both sides
    np.testing.assert_allclose(b.idepth_min.numpy()[both], np.asarray(a.idepth_min)[both],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(b.idepth_max.numpy()[both], np.asarray(a.idepth_max)[both],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(b.quality.numpy()[both], np.asarray(a.quality)[both],
                               rtol=1e-3)


def test_optimize_idepth_single_host(scene):
    F = 3
    rng = np.random.default_rng(7)
    d0 = np.clip(scene["idep"] * (1 + 0.3 * rng.normal(size=300)), 0.02, 5).astype(np.float32)
    a = jtrace.optimize_idepth(
        jnp.asarray(np.stack(scene["j_img3"])), jnp.ones(F, bool), jnp.asarray(scene["T_rel"]),
        jnp.ones(F, jnp.float32), jnp.zeros(F, jnp.float32), jnp.asarray(scene["uv"]),
        jnp.asarray(scene["colors"]), jnp.asarray(d0), jnp.asarray(scene["valid"]),
        jnp.asarray(scene["intr"]), 0, iters=3)
    b = ttrace.optimize_idepth(
        torch.stack(scene["t_img3"]), torch.ones(F, dtype=torch.bool),
        torch.from_numpy(scene["T_rel"]), torch.ones(F), torch.zeros(F),
        torch.from_numpy(scene["uv"]), torch.from_numpy(scene["colors"]),
        torch.from_numpy(d0), torch.from_numpy(scene["valid"]),
        torch.from_numpy(scene["intr"]), 0, iters=3)
    # 3 GN steps in f32 from the same start: idepth 1e-4 rel, sums 1e-3 rel
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=1e-4, atol=1e-5)
    for k in (1, 2):
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), rtol=1e-3, atol=1e-2)
    np.testing.assert_array_equal(b[3].numpy(), np.asarray(a[3]))


def _bank_numpy(scene, status_good=True):
    """A bank of 200 candidates hosted by slot 0 (the rest padding) with
    intervals around the ground truth."""
    N = CFG.shapes.max_immature
    bank = {f: np.array(v) for f, v in jbank.empty_bank(N)._asdict().items()}
    n = 200
    bank["valid"][:n] = scene["valid"][:n]
    bank["uv"][:n] = scene["uv"][:n]
    bank["color"][:n] = scene["colors"][:n]
    bank["idepth_min"][:n] = scene["idep"][:n] * 0.9
    bank["idepth_max"][:n] = scene["idep"][:n] * 1.1
    bank["quality"][:n] = np.linspace(2.0, 20.0, n)
    bank["last_status"][:n] = jtrace.GOOD if status_good else jtrace.OUTLIER
    return bank


def test_optimize_idepth_bank_and_activation(scene):
    F = 3
    T_all = np.stack([scene["ds"].gt_pose_c_w(i).astype(np.float32) for i in range(F)])
    x = np.zeros((F, 8), np.float32)
    x[:, 6] = [0.0, 0.01, -0.02]
    x[:, 7] = [0.0, 1.0, -0.5]
    expo = np.ones(F, np.float32)
    bank = _bank_numpy(scene)
    j_bank = jbank.Bank(**{f: jnp.asarray(v) for f, v in bank.items()})
    t_bank = convert.from_numpy("bank", bank, device="cpu")
    a = jtrace.activate_candidates_device(
        jnp.asarray(np.stack(scene["j_img3"])), jnp.ones(F, bool), jnp.asarray(T_all),
        jnp.asarray(x), jnp.asarray(expo), j_bank, jnp.asarray(scene["intr"]),
        float(CFG.trace.min_quality))
    b = ttrace.activate_candidates_device(
        torch.stack(scene["t_img3"]), torch.ones(F, dtype=torch.bool),
        torch.from_numpy(T_all), torch.from_numpy(x), torch.from_numpy(expo), t_bank,
        torch.from_numpy(scene["intr"]), float(CFG.trace.min_quality))
    np.testing.assert_array_equal(b["can"].numpy(), np.asarray(a["can"]))
    np.testing.assert_array_equal(b["count"].numpy(), np.asarray(a["count"]))
    # per-point sums over F·8 samples in another order, through 3 GN
    # steps: weakly constrained points (small H_dd) amplify the last ulps
    np.testing.assert_allclose(b["idepth"].numpy(), np.asarray(a["idepth"]),
                               rtol=1e-3, atol=1e-4)
    for k in ("H_dd", "energy"):
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), rtol=1e-3, atol=1e-2)
