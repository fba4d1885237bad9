"""One pyramid level of the tracker's LM loop: the port's plain version
(``tracker.track_level_torch``) against the JAX package's ``track_level``
(vmapped over the lanes) at the five level shapes of ``preset("default")``
at 640x480, the edge lanes, the dispatch of ``tracker.track_level``, and,
on a card, the CUDA kernel (``kernels/track_level.py``) against the plain
version.

The JAX package is imported inside the tests that use it, so that the
card's machine, which has no JAX, runs the kernel's tests:
``python -m pytest --noconftest -m gpu tests/test_torch_track_level.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldso_tpu_torch import tracker as ttr
from ldso_tpu_torch.cameras import level_intrinsics
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.io import synthetic
from ldso_tpu_torch.kernels import pyramid as tpyr
from ldso_tpu_torch.math import lie

CFG = preset("default")
TC = CFG.tracker
LEVELS = CFG.shapes.pyr_levels
N_POINTS = CFG.shapes.max_points          # 2048: N_l = 2048, 1024, 512, 256, 256
K = CFG.shapes.num_hypotheses             # 27 lanes on the two coarsest levels
ITERS = list(TC.max_iterations) + [50] * LEVELS
LM = dict(lam0=float(TC.lambda_initial), lam_success=float(TC.lambda_success),
          lam_fail=float(TC.lambda_fail), step_eps=float(TC.step_eps))
# test_torch_tracker.py::test_track_frame's bounds: LM in float32 on both
# sides, sums over up to 2048 terms in another order
T_ATOL, AB_ATOL, RMSE_RTOL = 2e-4, 2e-3, 2e-3
COUNT_FRAC = 0.01                          # counts agree within 1% of N_l


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    """One intra-op thread while this file runs, as the other heavy files
    (six test processes share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """Two 640x480 frames 0.12 apart, 2048 reference points of frame 0 at
    their true inverse depth (10% padding rows), the plain pyramid of frame
    1, the 27 hypotheses around 0.7·T_gt, all as numpy arrays."""
    ds = synthetic.SyntheticDataset(w=640, h=480, n=2, seed=0, supersample=1)
    ds.poses_w_c = synthetic.trajectory(2, "forward_arc", step=0.12)
    ds._cache = {}
    imgs = [ds.get_image(i)[0].astype(np.float32) for i in range(2)]
    rng = np.random.default_rng(6)
    idep = ds.get_idepth(0)
    gy, gx = np.gradient(imgs[0])
    gsq = gx ** 2 + gy ** 2
    ok = (idep > 1e-3) & (gsq > np.percentile(gsq, 70))
    ok[:8] = ok[-8:] = False
    ok[:, :8] = ok[:, -8:] = False
    cand = np.argwhere(ok)
    sel = cand[rng.choice(len(cand), size=N_POINTS, replace=False)]
    uv = np.stack([sel[:, 1], sel[:, 0]], -1).astype(np.float32)
    ref = ttr.make_tracker_ref(
        torch.from_numpy(uv), torch.from_numpy(idep[sel[:, 0], sel[:, 1]].astype(np.float32)),
        torch.from_numpy(imgs[0][sel[:, 0], sel[:, 1]]),
        torch.from_numpy(rng.random(N_POINTS) > 0.1), LEVELS)
    T_gt = (ds.gt_pose_c_w(1) @ ds.poses_w_c[0]).astype(np.float32)
    xi = lie.se3_log(torch.from_numpy(T_gt).double())
    T_rough = lie.se3_exp(0.7 * xi).float()
    pyr = tpyr.build_pyramid_torch(torch.from_numpy(imgs[1]), LEVELS)[0]
    intr = torch.from_numpy(np.asarray(ds.intrinsics(), np.float32))
    return dict(
        pyr=[p.numpy() for p in pyr],
        ref=[tuple(a[l].numpy() for a in (ref.uv, ref.idepth, ref.color, ref.valid))
             for l in range(LEVELS)],
        intr=[level_intrinsics(intr, l).numpy() for l in range(LEVELS)],
        hyps=ttr.motion_hypotheses(T_rough, K).numpy(),
        T_near=lie.se3_exp(0.9 * xi).float().numpy()[None],
        T_gt=T_gt)


def _level_case(scene, level):
    """(T0, ab0, iters) of a level as track_frame gives it: the 27 lanes
    at the two coarsest levels, the winner below them."""
    if level >= LEVELS - 2:
        return scene["hyps"], np.zeros((K, 2), np.float32), min(int(ITERS[level]), 12)
    return scene["T_near"], np.asarray([[0.02, -1.5]], np.float32), int(ITERS[level])


def _args(scene, level, T0, ab0, valid=None):
    uv, idepth, color, ref_valid = scene["ref"][level]
    img = scene["pyr"][level]
    return [img, uv, idepth, color, ref_valid if valid is None else valid, T0, ab0,
            scene["intr"][level]], dict(w=img.shape[1], h=img.shape[0])


def _plain(args, wh, iters, level, device="cpu", **kw):
    lm = dict(LM, **kw)
    return ttr.track_level_torch(*(torch.as_tensor(a, device=device) for a in args),
                                 wh["w"], wh["h"], iters, float(TC.coarse_cutoff_th * 2 ** level),
                                 float(TC.huber_th), **lm)


def _jax(args, wh, iters, level, **kw):
    import jax
    import jax.numpy as jnp

    from ldso_tpu import tracker as jtr

    lm = dict(LM, **kw)
    img, uv, idepth, color, valid, T0, ab0, intr_l = (jnp.asarray(a) for a in args)

    def one(T, ab):
        return jtr.track_level(img, uv, idepth, color, valid, T, ab, intr_l, wh["w"], wh["h"],
                               iters, float(TC.coarse_cutoff_th * 2 ** level),
                               float(TC.huber_th), **lm)

    return [np.asarray(x) for x in jax.vmap(one)(T0, ab0)]


def _assert_close(out_t, out_j, n_points):
    T_t, ab_t, rm_t, ok_t, in_t, sat_t = (np.asarray(x) for x in out_t)
    T_j, ab_j, rm_j, ok_j, in_j, sat_j = out_j
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=T_ATOL)
    np.testing.assert_allclose(ab_t, ab_j, rtol=0, atol=AB_ATOL)
    np.testing.assert_allclose(rm_t, rm_j, rtol=RMSE_RTOL, atol=1e-6)
    for a, b in ((ok_t, ok_j), (in_t, in_j), (sat_t, sat_j)):
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= COUNT_FRAC * n_points


@pytest.mark.parametrize("level", [4, 3, 2, 1, 0])
def test_plain_matches_jax_at_the_default_level_shapes(scene, level):
    T0, ab0, iters = _level_case(scene, level)
    args, wh = _args(scene, level, T0, ab0)
    n_l = len(args[1])
    assert n_l == min(N_POINTS, max(256, N_POINTS >> level))
    assert (wh["w"], wh["h"]) == (640 >> level, 480 >> level)
    out_t = _plain(args, wh, iters, level)
    out_j = _jax(args, wh, iters, level)
    _assert_close(out_t, out_j, n_l)
    # the lanes are compared one by one, so the same hypothesis wins
    assert int(torch.argmin(out_t[2])) == int(np.argmin(out_j[2]))
    if level == 0:
        # and the winner tracked: close to the ground truth
        dxi = lie.se3_log(torch.from_numpy(out_t[0][0].numpy().astype(np.float64)
                                           @ np.linalg.inv(scene["T_gt"])))
        assert float(torch.linalg.norm(dxi)) < 1e-2


def _behind(T):
    """A pose that puts every reference point behind the camera."""
    T = T.copy()
    T[2, 3] = -1000.0
    return T


def _edge_case(scene, case):
    """(args, wh, iters, level, lm overrides) of an edge case at level 4."""
    level = LEVELS - 1
    hyps = scene["hyps"]
    ab0 = np.zeros((2, 2), np.float32)
    if case == "behind":                   # lane 0 sees no point, lane 1 does
        T0 = np.stack([_behind(hyps[0]), hyps[1]])
        args, wh = _args(scene, level, T0, ab0)
        return args, wh, 12, level, {}
    if case == "no_valid":                 # no valid point at all
        n = len(scene["ref"][level][0])
        args, wh = _args(scene, level, hyps[:2], ab0, valid=np.zeros(n, bool))
        return args, wh, 12, level, {}
    # first_accept: every accepted step ends its lane
    args, wh = _args(scene, level, hyps, np.zeros((K, 2), np.float32))
    return args, wh, 12, level, dict(step_eps=1e3)


@pytest.mark.parametrize("case", ["behind", "no_valid", "first_accept"])
def test_plain_matches_jax_on_edge_lanes(scene, case):
    args, wh, iters, level, kw = _edge_case(scene, case)
    out_t = _plain(args, wh, iters, level, **kw)
    _assert_close(out_t, _jax(args, wh, iters, level, **kw), len(args[1]))
    T_t, ab_t, rm_t, ok_t, in_t, _ = out_t
    if case in ("behind", "no_valid"):
        # an empty lane: H = 0, E = 0, every step rejected until lambda > 1e3
        empty = [0] if case == "behind" else [0, 1]
        for k in empty:
            assert torch.equal(T_t[k], torch.from_numpy(args[5][k]))
            assert float(rm_t[k]) == 0.0 and int(ok_t[k]) == 0 and int(in_t[k]) == 0
    if case == "behind":
        assert int(ok_t[1]) > 0
    if case == "first_accept":
        # a lane whose first step is accepted stops there: it equals the
        # one-iteration run; lanes that first rejected went on
        one = _plain(args, wh, 1, level)
        moved = [k for k in range(K) if not torch.equal(one[0][k], torch.from_numpy(args[5][k]))]
        assert moved
        for k in moved:
            assert torch.equal(T_t[k], one[0][k]) and torch.equal(ab_t[k], one[1][k])


def test_dispatch_takes_the_plain_version_for_cpu_tensors(scene):
    level = LEVELS - 1
    T0, ab0, iters = _level_case(scene, level)
    args, wh = _args(scene, level, T0[:3], ab0[:3])
    cut, hub = float(TC.coarse_cutoff_th * 2 ** level), float(TC.huber_th)
    t_args = [torch.from_numpy(a) for a in args]
    out = ttr.track_level(*t_args, wh["w"], wh["h"], iters, cut, hub, **LM)
    ref = ttr.track_level_torch(*t_args, wh["w"], wh["h"], iters, cut, hub, **LM)
    assert len(out) == 6
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ttr.track_level(*(a.to("meta") for a in t_args), wh["w"], wh["h"], iters, cut, hub)


def test_cuda_wrapper_refuses_cpu_tensors(scene):
    from ldso_tpu_torch.kernels.track_level import track_level_cuda

    level = LEVELS - 1
    T0, ab0, iters = _level_case(scene, level)
    args, wh = _args(scene, level, T0, ab0)
    with pytest.raises(ValueError):
        track_level_cuda(*(torch.from_numpy(a) for a in args), wh["w"], wh["h"], iters,
                         20.0, 9.0)


def test_wrapper_imports_without_nvcc():
    # nothing is built at import: no nvcc on PATH, no CUDA_HOME
    code = ("import ldso_tpu_torch.kernels.track_level as k, "
            "ldso_tpu_torch.kernels.cuda_build as b; assert k.LAUNCHES == 0\n"
            "try:\n    b.nvcc()\nexcept RuntimeError:\n    pass\n"
            "else:\n    raise SystemExit('nvcc found')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=os.path.join(root, "no-cuda-here"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_level_intrinsics_of_every_level_at_once():
    intr = torch.tensor([563.2, 561.7, 319.5, 239.25])
    every = ttr._level_intrinsics_all(intr, LEVELS)
    for l in range(LEVELS):
        assert torch.equal(every[l], level_intrinsics(intr, l))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("level", [4, 3, 2, 1, 0])
def test_cuda_kernel_matches_plain(scene, level):
    dev = _cuda_or_skip()
    from ldso_tpu_torch.kernels import track_level as ktl

    T0, ab0, iters = _level_case(scene, level)
    args, wh = _args(scene, level, T0, ab0)
    d_args = [torch.as_tensor(a, device=dev) for a in args]
    before = ktl.LAUNCHES
    out_k = ktl.track_level_cuda(*d_args, wh["w"], wh["h"], iters,
                                 float(TC.coarse_cutoff_th * 2 ** level), float(TC.huber_th),
                                 **LM)
    torch.cuda.synchronize()
    assert ktl.LAUNCHES == before + 1
    out_p = _plain(args, wh, iters, level, device=dev)
    n_iter = out_k[6].cpu().numpy()
    assert ((n_iter >= 1) & (n_iter <= iters)).all()
    # n_ok summed over the 1 + n_iter evaluations holds the final state's
    n_ok, n_ok_sum = out_k[3].cpu().numpy(), out_k[7].cpu().numpy()
    assert ((n_ok_sum >= n_ok) & (n_ok_sum <= len(args[1]) * (1 + n_iter))).all()
    _assert_close([x.cpu() for x in out_k[:6]], [x.cpu().numpy() for x in out_p],
                  len(args[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["behind", "no_valid", "first_accept"])
def test_cuda_kernel_on_edge_lanes(scene, case):
    dev = _cuda_or_skip()
    from ldso_tpu_torch.kernels import track_level as ktl

    args, wh, iters, level, kw = _edge_case(scene, case)
    d_args = [torch.as_tensor(a, device=dev) for a in args]
    out_k = ktl.track_level_cuda(*d_args, wh["w"], wh["h"], iters,
                                 float(TC.coarse_cutoff_th * 2 ** level), float(TC.huber_th),
                                 **dict(LM, **kw))
    out_p = _plain(args, wh, iters, level, device=dev, **kw)
    _assert_close([x.cpu() for x in out_k[:6]], [x.cpu().numpy() for x in out_p],
                  len(args[1]))
    n_iter = out_k[6].cpu().numpy()
    if case in ("behind", "no_valid"):
        # lambda 0.01 · 4^9 > 1e3: nine rejected steps end an empty lane
        for k in ([0] if case == "behind" else [0, 1]):
            assert n_iter[k] == 9
            assert int(out_k[7][k]) == 0
            assert torch.equal(out_k[0][k].cpu(), torch.from_numpy(args[5][k]))
    if case == "first_accept":
        one = ktl.track_level_cuda(*d_args, wh["w"], wh["h"], 1,
                                   float(TC.coarse_cutoff_th * 2 ** level),
                                   float(TC.huber_th), **LM)
        moved = (one[0] != d_args[5]).flatten(1).any(1)
        assert bool(moved.any())
        assert bool((out_k[6][moved] == 1).all())
        assert torch.equal(out_k[0][moved], one[0][moved])
