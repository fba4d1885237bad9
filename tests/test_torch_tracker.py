"""tracker.py of the port against the JAX package: the reference lists,
the per-level 8x8 system element-wise, the batched per-lane LM ladder
(the same hypothesis wins) and the full pyramidal track."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu import tracker as jtr
from ldso_tpu.cameras import level_intrinsics as j_level_intr
from ldso_tpu.config import preset
from ldso_tpu.kernels import interp as ji
from ldso_tpu.kernels import pyramid as jpyr
from ldso_tpu.math import lie as jl
from ldso_tpu_torch import tracker as ttr
from ldso_tpu_torch.cameras import level_intrinsics as t_level_intr
from ldso_tpu_torch.io import synthetic
from ldso_tpu_torch.kernels import interp as ti
from ldso_tpu_torch.kernels import pyramid as tpyr

CFG = preset("tiny")
LEVELS = CFG.shapes.pyr_levels


@pytest.fixture(scope="module")
def scene():
    """Two frames 0.12 apart, a GT-depth reference point set on frame 0
    (30% padding rows), both pyramids, and hypotheses around 0.7·T_gt."""
    ds = synthetic.SyntheticDataset(w=256, h=192, n=2, seed=0, supersample=1)
    ds.poses_w_c = synthetic.trajectory(2, "forward_arc", step=0.12)
    ds._cache = {}
    imgs = [ds.get_image(i)[0].astype(np.float32) for i in range(2)]
    rng = np.random.default_rng(1)
    idep = ds.get_idepth(0)
    gy, gx = np.gradient(imgs[0])
    ok = (idep > 1e-3) & (gx ** 2 + gy ** 2 > np.percentile(gx ** 2 + gy ** 2, 60))
    ok[:8] = ok[-8:] = False
    ok[:, :8] = ok[:, -8:] = False
    cand = np.argwhere(ok)
    sel = cand[rng.choice(len(cand), size=400, replace=False)]
    uv = np.stack([sel[:, 1], sel[:, 0]], -1).astype(np.float32)
    pts = dict(uv=uv, idepth=idep[sel[:, 0], sel[:, 1]].astype(np.float32),
               color=imgs[0][sel[:, 0], sel[:, 1]], valid=rng.random(400) > 0.3)
    T_gt = (ds.gt_pose_c_w(1) @ ds.poses_w_c[0]).astype(np.float32)
    T_rough = np.asarray(jl.se3_exp(jl.se3_log(jnp.asarray(T_gt, jnp.float64)) * 0.7),
                         np.float32)
    hyps = np.array(jtr.motion_hypotheses(jnp.asarray(T_rough), 5), np.float32)
    j_pyr = jpyr.build_pyramid_xla(jnp.asarray(imgs[1]), LEVELS)[0]
    t_pyr = tpyr.build_pyramid_torch(torch.from_numpy(imgs[1]), LEVELS)[0]
    args = [pts[k] for k in ("uv", "idepth", "color", "valid")]
    j_ref = jtr.make_tracker_ref(*map(jnp.asarray, args), LEVELS)
    t_ref = ttr.make_tracker_ref(*map(torch.from_numpy, args), LEVELS)
    return dict(ds=ds, intr=ds.intrinsics(), T_gt=T_gt, T_rough=T_rough, hyps=hyps,
                j_pyr=j_pyr, t_pyr=t_pyr, j_ref=j_ref, t_ref=t_ref)


def test_make_tracker_ref(scene):
    j, t = scene["j_ref"], scene["t_ref"]
    for l in range(LEVELS):
        # the same stable valid-first selection; uv scaling is exact
        np.testing.assert_array_equal(t.valid[l].numpy(), np.asarray(j.valid[l]))
        np.testing.assert_array_equal(t.idepth[l].numpy(), np.asarray(j.idepth[l]))
        np.testing.assert_allclose(t.uv[l].numpy(), np.asarray(j.uv[l]), rtol=0, atol=1e-6)


def test_motion_hypotheses(scene):
    a = np.asarray(jtr.motion_hypotheses(jnp.asarray(scene["T_rough"]), 27))
    b = ttr.motion_hypotheses(torch.from_numpy(scene["T_rough"]), 27).numpy()
    # float32 log/exp round trip on both sides
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("level", [0, 2])
def test_level_system_elementwise(scene, level):
    j_ref, t_ref = scene["j_ref"], scene["t_ref"]
    img = scene["j_pyr"][level]
    h, w = img.shape[0], img.shape[1]
    T = scene["hyps"][:3]
    ab = np.asarray([[0.0, 0.0], [0.02, -1.0], [-0.01, 2.0]], np.float32)
    cutoff = float(CFG.tracker.coarse_cutoff_th * 2 ** level)
    packed_j = ji.pack_corners(img)
    intr_j = j_level_intr(jnp.asarray(scene["intr"]), level)
    H, b, E, n_ok, n_in, n_sat = ttr._level_system(
        ti.pack_corners(scene["t_pyr"][level]), t_ref.uv[level], t_ref.idepth[level],
        t_ref.color[level], t_ref.valid[level], torch.from_numpy(T), torch.from_numpy(ab),
        t_level_intr(torch.from_numpy(scene["intr"]), level), w, h, cutoff, 9.0)
    for k in range(3):
        ref = jtr._level_system(packed_j, j_ref.uv[level], j_ref.idepth[level],
                                j_ref.color[level], j_ref.valid[level],
                                jnp.asarray(T[k]), jnp.asarray(ab[k]), intr_j, w, h,
                                cutoff, 9.0)
        # counts are discrete decisions on identical projections: exact
        assert int(n_ok[k]) == int(ref[3]) and int(n_in[k]) == int(ref[4])
        assert int(n_sat[k]) == int(ref[5])
        # sums over a few hundred f32 terms in another order
        scale = float(np.abs(np.asarray(ref[0])).max())
        np.testing.assert_allclose(H[k].numpy(), np.asarray(ref[0]), rtol=1e-4,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(b[k].numpy(), np.asarray(ref[1]), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(np.asarray(ref[1])).max()))
        np.testing.assert_allclose(float(E[k]), float(ref[2]), rtol=1e-4)


def test_batched_lanes_pick_the_same_hypothesis(scene):
    """The coarse stage of track_frame: per-lane LM with per-lane stopping
    (vmapped while_loop in JAX, masked batch here)."""
    j_ref, t_ref, intr = scene["j_ref"], scene["t_ref"], scene["intr"]
    tc = CFG.tracker
    kw = dict(lam0=float(tc.lambda_initial), lam_success=float(tc.lambda_success),
              lam_fail=float(tc.lambda_fail), step_eps=float(tc.step_eps))
    T_j = jnp.asarray(scene["hyps"])
    ab_j = jnp.zeros((5, 2), jnp.float32)
    T_t = torch.from_numpy(scene["hyps"])
    ab_t = torch.zeros((5, 2))
    for l in (LEVELS - 1, LEVELS - 2):
        h, w = scene["j_pyr"][l].shape[:2]
        cut = float(tc.coarse_cutoff_th * 2 ** l)
        intr_l = j_level_intr(jnp.asarray(intr), l)
        fn = jax.vmap(lambda T0, ab0: jtr.track_level(
            scene["j_pyr"][l], j_ref.uv[l], j_ref.idepth[l], j_ref.color[l],
            j_ref.valid[l], T0, ab0, intr_l, w, h, 12, cut, 9.0, **kw))
        T_j, ab_j, rm_j, *_ = fn(T_j, ab_j)
        T_t, ab_t, rm_t, *_ = ttr.track_level(
            scene["t_pyr"][l], t_ref.uv[l], t_ref.idepth[l], t_ref.color[l],
            t_ref.valid[l], T_t, ab_t, t_level_intr(torch.from_numpy(intr), l),
            w, h, 12, cut, 9.0, **kw)
        # per-lane LM over 12 iterations in f32: 1e-4 on poses, 1e-3 on rmse
        np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
        np.testing.assert_allclose(rm_t.numpy(), np.asarray(rm_j), rtol=1e-3)
    assert int(torch.argmin(rm_t)) == int(jnp.argmin(rm_j))


def test_track_frame(scene):
    intr = scene["intr"]
    a = jtr.track_frame(scene["j_pyr"], scene["j_ref"], jnp.asarray(scene["hyps"]),
                        jnp.zeros(2, jnp.float32), jnp.asarray(intr), CFG)
    b = ttr.track_frame(scene["t_pyr"], scene["t_ref"], torch.from_numpy(scene["hyps"]),
                        torch.zeros(2), torch.from_numpy(intr), CFG)
    # full coarse-to-fine LM in f32 on both sides
    np.testing.assert_allclose(b.T.numpy(), np.asarray(a.T), atol=2e-4)
    np.testing.assert_allclose(b.ab.numpy(), np.asarray(a.ab), atol=2e-3)
    np.testing.assert_allclose(b.rmse.numpy(), np.asarray(a.rmse), rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(b.flow.numpy(), np.asarray(a.flow), rtol=1e-3)
    np.testing.assert_allclose(float(b.frac_oob), float(a.frac_oob), atol=1e-6)
    # and it tracked: close to ground truth
    err = np.linalg.norm(jl.se3_log(jnp.asarray(
        b.T.numpy().astype(np.float64) @ np.linalg.inv(scene["T_gt"]))))
    assert err < 1e-2


def test_flow_indicators(scene):
    T = scene["T_gt"]
    a = np.asarray(jtr._flow_indicators(scene["j_ref"], jnp.asarray(T),
                                        jnp.asarray(scene["intr"])))
    b = ttr._flow_indicators(scene["t_ref"], torch.from_numpy(T),
                             torch.from_numpy(scene["intr"])).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5)
