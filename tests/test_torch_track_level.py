"""One pyramid level of the tracker's LM loop: the port's plain version
(``tracker.track_level_torch``) against the JAX package's ``track_level``
(vmapped over the lanes) at the five level shapes of ``preset("default")``
at 640x480, the edge lanes, the dispatch of ``tracker.track_level``, the
level plan and the winner rule of the two-launch frame, the wrapper's
refusals, and, on a card, the CUDA kernel (``kernels/track_level.py``)
against the plain version at both launch shapes (many lanes, one CTA a
lane; one lane, a cluster of 8), and its two-launch frame against one-level launches chained on their own
outputs, bit for bit, and against a second run.

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
from ldso_tpu_torch.kernels import track_level as ktl
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
    level = LEVELS - 1
    T0, ab0, iters = _level_case(scene, level)
    args, wh = _args(scene, level, T0, ab0)
    with pytest.raises(ValueError):
        ktl.track_level_cuda(*(torch.from_numpy(a) for a in args), wh["w"], wh["h"], iters,
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


# ---- the two-launch frame (kernels/track_level.track_levels_cuda)

def _frame(scene, device="cpu", lanes=K):
    """A tracked frame's tensors from the scene: the pyramid, the tracker
    ref, ``lanes`` hypotheses, ab_init [2] and the level-0 intrinsics."""
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    refs = scene["ref"]
    ref = ttr.TrackerRef(*(tuple(as_t(refs[l][i]) for l in range(LEVELS)) for i in range(4)),
                         exposure=as_t(np.float32(1.0)), aff_ab=as_t(np.zeros(2, np.float32)))
    return ([as_t(p) for p in scene["pyr"]], ref, as_t(scene["hyps"][:lanes]),
            as_t(np.asarray([0.01, -0.5], np.float32)), as_t(scene["intr"][0]))


def test_level_plan_is_the_chain_of_chip_smoke(scene):
    import chip_smoke as cs

    pyr, ref, T_inits, ab_init, intr = _frame(scene, lanes=3)
    coarse, fine = ttr.level_plan(pyr, ref, TC)
    intr_levels = ttr._level_intrinsics_all(intr, LEVELS)
    walked = list(cs.track_level_chain((pyr, ref, T_inits, ab_init, intr, CFG)))
    assert [p.level for p in coarse + fine] == [l for l, _, _, _ in walked] == [4, 3, 2, 1, 0]
    for p, (l, lv, kw, _) in zip(coarse + fine, walked):
        assert (p.h, p.w, p.n) == (kw["h"], kw["w"], lv[1].shape[0])
        assert p.cap == kw["iters"] and p.cutoff == kw["cutoff"]
        assert torch.equal(intr_levels[p.intr_row], lv[7])
    assert [p.cap for p in coarse] == [12, 12] and [p.cap for p in fine] == [50, 30, 16]


def _pick_like_the_kernel(rm):
    """The kernel's winner rule written out (csrc/track_level.cu
    pick_winner): NaN and +-inf as +inf; lane l of a warp scans entries
    l, l + 32, ... keeping the first smallest; a butterfly over the 32
    lanes keeps the smaller value, at equal values the lower index."""
    inf, none = float("inf"), 2 ** 31 - 1
    vals = [inf if (x != x or abs(x) == inf) else x for x in rm]
    v, idx = [inf] * 32, [none] * 32
    for lane in range(32):
        for q in range(lane, len(vals), 32):
            if idx[lane] == none or vals[q] < v[lane]:
                v[lane], idx[lane] = vals[q], q
    off = 16
    while off:
        v2, i2 = list(v), list(idx)
        for lane in range(32):
            ov, oi = v[lane ^ off], idx[lane ^ off]
            if ov < v[lane] or (ov == v[lane] and oi < idx[lane]):
                v2[lane], i2[lane] = ov, oi
        v, idx, off = v2, i2, off // 2
    assert len(set(idx)) == 1
    return idx[0]


@pytest.mark.parametrize("case", ["random", "nan", "posinf", "neginf", "ties", "all_inf",
                                  "all_nan", "many_lanes_tie", "one_lane"])
def test_winner_rule_is_argmin_over_nan_to_num(case):
    rng = np.random.default_rng(11)
    n = 40 if case == "many_lanes_tie" else 1 if case == "one_lane" else K
    rm = rng.random(n).astype(np.float32) + 1.0
    inf = np.float32(np.inf)
    if case == "nan":
        rm[[0, 5, 9]] = np.nan
        rm[7] = 0.5
    elif case == "posinf":
        rm[0] = inf
        rm[3] = 0.25
    elif case == "neginf":                 # -inf counts as +inf, not as the smallest
        rm[2] = -inf
    elif case == "ties":
        rm[[4, 11, 20]] = 0.125
    elif case == "all_inf":
        rm[:] = inf
        rm[::2] = -inf
    elif case == "all_nan":
        rm[:] = np.nan
    elif case == "many_lanes_tie":         # a tie across the strided scan (lanes 1 and 33)
        rm[[33, 1, 39]] = 0.0625
    t = torch.from_numpy(rm)
    want = int(torch.argmin(torch.nan_to_num(t, nan=float("inf"), posinf=float("inf"),
                                             neginf=float("inf"))))
    assert _pick_like_the_kernel(rm.tolist()) == want


def test_fused_entry_refuses_cpu_and_non_contiguous_tensors(scene):
    pyr, ref, T_inits, ab_init, intr = _frame(scene)
    plan = ttr.level_plan(pyr, ref, TC)
    intr_levels = ttr._level_intrinsics_all(intr, LEVELS)
    lm = dict(LM, huber_th=float(TC.huber_th))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ktl.track_levels_cuda(pyr, ref, plan, intr_levels, T_inits, ab_init, **lm)
    with pytest.raises(ValueError, match="T0 is not contiguous"):
        ktl.track_levels_cuda(pyr, ref, plan, intr_levels, T_inits.transpose(1, 2), ab_init,
                              **lm)
    wide = torch.cat([ref.uv[4], ref.uv[4]], 1)[:, :2]
    bad = ref._replace(uv=ref.uv[:4] + (wide,))
    with pytest.raises(ValueError, match="level 0 uv is not contiguous"):
        ktl.track_levels_cuda(pyr, bad, plan, intr_levels, T_inits, ab_init, **lm)


def test_launch_config_one_table_per_lane_count():
    # many lanes (the coarse levels): one CTA a lane; one lane (the fine
    # levels): a cluster of 8, the portable size
    for lanes in (K, 2):
        assert ktl.launch_config(lanes) == ktl.COARSE_LAUNCH == (1, 256)
    assert ktl.launch_config(1) == ktl.FINE_LAUNCH == (8, 256)


@pytest.mark.gpu
def test_cuda_two_launches_equal_chained_one_level_calls_bitwise(scene):
    dev = _cuda_or_skip()
    d_frame = _frame(scene, device=dev)
    pyr, ref, T_inits, ab_init, intr = d_frame
    plan = ttr.level_plan(pyr, ref, TC)
    intr_levels = ttr._level_intrinsics_all(intr, LEVELS)
    before = ktl.LAUNCHES
    out = ktl.track_levels_cuda(pyr, ref, plan, intr_levels, T_inits, ab_init,
                                float(TC.huber_th), **LM)
    assert ktl.LAUNCHES == before + 2
    import chip_smoke as cs

    outs, best = cs.kernel_level_chain((*d_frame, CFG))
    assert int(out.best[0]) == best
    for p in plan[0] + plan[1]:
        lanes = K if p in plan[0] else 1
        for name, a, b in zip(ktl.LevelsOut._fields, out[:8], outs[p.level]):
            assert torch.equal(a[p.level, :lanes], b), (p.level, name)


@pytest.mark.gpu
def test_cuda_two_launches_repeat_bitwise_and_track_frame_reads_them(scene):
    dev = _cuda_or_skip()
    pyr, ref, T_inits, ab_init, intr = _frame(scene, device=dev)
    plan = ttr.level_plan(pyr, ref, TC)
    intr_levels = ttr._level_intrinsics_all(intr, LEVELS)
    import chip_smoke as cs

    runs = [ktl.track_levels_cuda(pyr, ref, plan, intr_levels, T_inits, ab_init,
                                  float(TC.huber_th), **LM) for _ in range(2)]
    for (field, l, a), (_, _, b) in zip(*(cs.written_levels(r, plan) for r in runs)):
        assert torch.equal(a, b), (field, l)
    before = ktl.LAUNCHES
    res = ttr.track_frame(pyr, ref, T_inits, ab_init, intr, CFG)
    assert ktl.LAUNCHES == before + 2
    assert torch.equal(res.T, runs[0].T[0, 0]) and torch.equal(res.ab, runs[0].ab[0, 0])
    assert torch.equal(res.rmse[:3], runs[0].rmse[:3, 0])
    assert bool((res.rmse[3:] == 0).all())
    # the whole frame against the plain chain on the card
    plain = ttr._run_levels_plain(pyr, ref, T_inits, ab_init, intr_levels, plan, TC)
    np.testing.assert_allclose(res.T.cpu(), plain[0].cpu(), rtol=0, atol=T_ATOL)
    np.testing.assert_allclose(res.rmse.cpu(), plain[2].cpu(), rtol=RMSE_RTOL, atol=1e-6)


def _one_lane_at_a_time(fn, d_args):
    """``fn`` on each lane of d_args (T0, ab0 at 5, 6) alone, the outputs
    stacked: one-lane launches take the fine levels' cluster."""
    outs = [fn([a[k:k + 1] if i in (5, 6) else a for i, a in enumerate(d_args)])
            for k in range(d_args[5].shape[0])]
    return [torch.cat(xs) for xs in zip(*outs)]


def _assert_close_but_ties(lv, kw, out_k, out_p):
    """``_assert_close`` of the kernel's and the plain version's results,
    but with ``chip_smoke.check_track_level``'s rule for ties: a lane whose
    ab differs by more than AB_ATOL must be one whose two runs part at an
    LM accept decision the float32 sums cannot resolve
    (``chip_smoke._tie_parting``), and keeps ab within
    ``chip_smoke.TRACK_TIE_AB_ATOL``; at most ``TRACK_MAX_TIES`` such lanes."""
    import chip_smoke as cs

    d_ab = (out_k[1] - out_p[1]).abs().amax(1)
    tied = torch.nonzero(d_ab > AB_ATOL).flatten().tolist()
    assert len(tied) <= cs.TRACK_MAX_TIES
    for k in tied:
        assert cs._tie_parting(lv, kw, k) is not None, k
        assert float(d_ab[k]) <= cs.TRACK_TIE_AB_ATOL, k
    ab_k = out_k[1].clone()
    ab_k[tied] = out_p[1][tied]              # held to the tie bound above
    _assert_close([out_k[0].cpu(), ab_k.cpu()] + [x.cpu() for x in out_k[2:6]],
                  [x.cpu().numpy() for x in out_p], lv[1].shape[0])


@pytest.mark.gpu
@pytest.mark.parametrize("level,lanes", [(l, n) for l in (4, 3, 2, 1, 0) for n in ("many", "one")])
def test_cuda_kernel_matches_plain_at_every_cluster_size(scene, level, lanes):
    # each level at both launch shapes: many lanes (one CTA a lane) and one
    # lane (a cluster of 8)
    dev = _cuda_or_skip()
    T0, ab0, iters = _level_case(scene, level)
    if lanes == "one":
        T0, ab0 = T0[:1], ab0[:1]
    elif T0.shape[0] == 1:                 # the winner and two small rotations of it
        xi = torch.zeros(3, 6)
        xi[1, 3], xi[2, 4] = 2e-3, -2e-3
        T0 = (lie.se3_exp(xi) @ torch.from_numpy(T0)).numpy()
        ab0 = np.repeat(ab0, 3, axis=0)
    args, wh = _args(scene, level, T0, ab0)
    d_args = [torch.as_tensor(a, device=dev) for a in args]
    cut = float(TC.coarse_cutoff_th * 2 ** level)
    out_k = ktl.track_level_cuda(*d_args, wh["w"], wh["h"], iters, cut, float(TC.huber_th),
                                 **LM)
    out_p = _plain(args, wh, iters, level, device=dev)
    _assert_close_but_ties(d_args, dict(w=wh["w"], h=wh["h"], iters=iters, cutoff=cut,
                                        huber_th=float(TC.huber_th), **LM), out_k, out_p)
    again = ktl.track_level_cuda(*d_args, wh["w"], wh["h"], iters, cut, float(TC.huber_th),
                                 **LM)
    for a, b in zip(out_k, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["behind", "no_valid", "first_accept"])
@pytest.mark.parametrize("lanes", ["together", "alone"])
def test_cuda_kernel_on_edge_lanes_at_every_cluster_size(scene, case, lanes):
    # the lanes in one launch (one CTA a lane), or each alone (a cluster of 8)
    dev = _cuda_or_skip()
    args, wh, iters, level, kw = _edge_case(scene, case)
    d_args = [torch.as_tensor(a, device=dev) for a in args]

    def run(a):
        return ktl.track_level_cuda(*a, wh["w"], wh["h"], iters,
                                    float(TC.coarse_cutoff_th * 2 ** level), float(TC.huber_th),
                                    **dict(LM, **kw))

    out_k = run(d_args) if lanes == "together" else _one_lane_at_a_time(run, d_args)
    out_p = _plain(args, wh, iters, level, device=dev, **kw)
    _assert_close([x.cpu() for x in out_k[:6]], [x.cpu().numpy() for x in out_p],
                  len(args[1]))
    if case in ("behind", "no_valid"):
        for k in ([0] if case == "behind" else [0, 1]):
            assert int(out_k[6][k]) == 9 and int(out_k[7][k]) == 0
