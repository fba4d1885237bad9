"""init2f.py of the port against the JAX package: one init_level GN run
(before and after the parallax snap) and the whole two-frame bootstrap
(the analog of tests/test_init.py::test_bootstrap_recovers_structure)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu import init2f as jinit
from ldso_tpu.config import preset
from ldso_tpu.kernels import pyramid as jpyr
from ldso_tpu_torch import init2f as tinit
from ldso_tpu_torch.io import synthetic
from ldso_tpu_torch.kernels import pyramid as tpyr

CFG = preset("tiny")
LEVELS = CFG.shapes.pyr_levels


@pytest.fixture(scope="module")
def seq():
    n = 10
    ds = synthetic.SyntheticDataset(w=256, h=192, n=n, seed=2)
    ds.poses_w_c = synthetic.trajectory(n, "forward_arc", step=0.08)
    ds._cache = {}
    imgs = [ds.get_image(i)[0].astype(np.float32) for i in range(n)]
    j = [jpyr.build_pyramid_xla(jnp.asarray(im), LEVELS) for im in imgs]
    t = [tpyr.build_pyramid_torch(torch.from_numpy(im), LEVELS) for im in imgs]
    return ds, j, t


def test_median_is_midpoint():
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [1.0, 1.0, 5.0, 7.0]])
    np.testing.assert_array_equal(tinit._median_midpoint(x).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(x.numpy()), axis=-1)))


@pytest.mark.parametrize("snapped", [False, True])
def test_init_level(seq, snapped):
    ds, j, t = seq
    ji = jinit.CoarseInitializer(CFG, ds.intrinsics())
    ji.set_first(*j[0])
    level, iters = 2, 8
    rng = np.random.default_rng(0)
    n = CFG.shapes.init_points
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = [0.0, 0.0, 0.1]
    d0 = (1.0 + 0.1 * rng.normal(size=n)).astype(np.float32)
    args_np = [np.asarray(ji.uv), np.asarray(ji.colors[level]), np.asarray(ji.neighbors),
               T0, np.zeros(2, np.float32), d0, d0.copy(), np.asarray(ji.valid0),
               ds.intrinsics()]
    kw = dict(level=level, iters=iters, snapped=snapped)
    a = jinit.init_level(j[3][0][level], *map(jnp.asarray, args_np), **kw)
    b = tinit.init_level(t[3][0][level], *[torch.tensor(x) for x in args_np], **kw)
    # iters joint GN steps over ~250 points in f32, sums in another order
    np.testing.assert_allclose(b.T.numpy(), np.asarray(a.T), atol=1e-4)
    np.testing.assert_allclose(b.idepth.numpy(), np.asarray(a.idepth), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(b.iR.numpy(), np.asarray(a.iR), rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(b.good.numpy(), np.asarray(a.good))
    np.testing.assert_allclose(float(b.energy), float(a.energy), rtol=1e-3)


def _gt_errors(ds, res, last):
    """The ground-truth checks of tests/test_init.py: translation direction
    cosine, rotation error, median (scale-aligned) structure error."""
    from ldso_tpu.math import lie as jl

    T_gt = ds.gt_pose_c_w(last) @ ds.poses_w_c[0]
    t_est, t_gt = res["T_first_to_new"][:3, 3], T_gt[:3, 3]
    cos = float(t_est @ t_gt / (np.linalg.norm(t_est) * np.linalg.norm(t_gt) + 1e-12))
    rot = float(np.linalg.norm(np.asarray(jl.se3_log(jnp.asarray(
        res["T_first_to_new"] @ np.linalg.inv(T_gt), jnp.float64)))[3:]))
    uv = res["uv"].astype(int)
    gt = ds.get_idepth(0)[uv[:, 1], uv[:, 0]]
    ok = res["good"] & (gt > 1e-3)
    est = res["idepth"][ok]
    s = np.median(gt[ok] / est)
    return cos, rot, float(np.median(np.abs(est * s - gt[ok]) / gt[ok]))


def test_bootstrap_sequence(seq):
    ds, j, t = seq
    ji = jinit.CoarseInitializer(CFG, ds.intrinsics())
    ti = tinit.CoarseInitializer(CFG, ds.intrinsics(), "cpu")
    ji.set_first(*j[0])
    ti.set_first(*t[0])
    # the same bootstrap points (bitwise-equal selection) and kNN graph
    np.testing.assert_array_equal(ti.uv.numpy(), np.asarray(ji.uv))
    np.testing.assert_array_equal(ti.neighbors.numpy(), np.asarray(ji.neighbors))
    last = None
    for i in range(1, len(j)):
        sa, sb = ji.track(j[i][0]), ti.track(t[i][0])
        assert (sa["snapped"], sa["done"]) == (sb["snapped"], sb["done"]), (i, sa, sb)
        assert abs(sa["n_good"] - sb["n_good"]) <= 2, (i, sa, sb)
        if i == 1:
            # the first frame runs from identical state: f32 agreement
            np.testing.assert_allclose(ti.T.numpy(), np.asarray(ji.T), atol=1e-5)
            np.testing.assert_allclose(ti.idepth.numpy(), np.asarray(ji.idepth),
                                       rtol=1e-4, atol=1e-4)
        if sa["done"]:
            last = i
            break
    assert last is not None, "bootstrap never finished"
    ra, rb = ji.results(), ti.results()
    # After the snap the joint (translation, idepth) scale is a gauge the
    # coupled GN leaves free: last-ulp differences walk along it, so the raw
    # scale and the weakly observed directions drift apart over the ~5
    # post-snap frames of 100-iteration LM. results() normalizes the scale
    # (mean idepth 1); the normalized structure and pose must agree to well
    # inside the accuracy either has against ground truth.
    both = ra["good"] & rb["good"]
    assert both.sum() >= 0.98 * max(ra["good"].sum(), rb["good"].sum())
    rel = np.abs(rb["idepth"][both] - ra["idepth"][both]) / ra["idepth"][both]
    assert np.median(rel) < 0.01, np.median(rel)
    R_d = rb["T_first_to_new"][:3, :3] @ ra["T_first_to_new"][:3, :3].T
    assert np.arccos(np.clip((np.trace(R_d) - 1) / 2, -1, 1)) < 5e-3
    ta, tb = ra["T_first_to_new"][:3, 3], rb["T_first_to_new"][:3, 3]
    assert ta @ tb / (np.linalg.norm(ta) * np.linalg.norm(tb)) > 0.999
    for res in (ra, rb):
        cos, rot, structure = _gt_errors(ds, res, last)
        assert cos > 0.98 and rot < 0.02 and structure < 0.15, (cos, rot, structure)
