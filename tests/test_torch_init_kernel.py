"""The bootstrap's Gauss-Newton loop at one pyramid level (K6): the
dispatch of ``init2f.init_level`` (CPU -> the plain version
``init_level_torch``, bit for bit and without a launch), the wrapper's
launch shape (``launch_config``: the source's cluster, what its shared
memory holds, MAX_POINTS) and refusals (before any build), the plain version
against the JAX package's ``init_level`` at full width (1024 points, 10
neighbours, the 640x480 bench frames) and at 2048 points, chip_smoke's K6
yardsticks on the CPU (the plain chain, the ladder rule, G1's comparison,
the bound, the bootstrap's capture, the wide check's levels and the whole
bootstrap's check), and, on a card, the CUDA kernel
(``kernels/init_level.py``) against the plain version at the ``tiny`` and
``default`` shapes and at 1024 and 2048 points, before and after the snap,
one level at MAX_POINTS / 2 and at MAX_POINTS, the same bits in a second
launch, and one launch a call.

The JAX package is imported inside the test that uses it, so that the
card's machine, which has no JAX, runs the kernel's tests:
``python -m pytest --noconftest -m gpu tests/test_torch_init_kernel.py``.
"""

import contextlib
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from ldso_tpu_torch import init2f
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.kernels import cuda_build
from ldso_tpu_torch.kernels import init_level as kinit
from ldso_tpu_torch.kernels.pyramid import build_pyramid_torch

BENCH_FRAMES = (0, 4)        # the first frame and one tracked against it


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    """One intra-op thread while this file runs, as the other heavy files
    (six test processes share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench():
    """Frames 0 and 4 of the 640x480 bench sequence (uint8, as chip_smoke
    renders them) and the sequence's intrinsics."""
    frames = [cs._render_frames(cs.N_FRAMES, cs.W, cs.H, 3, "forward_arc", i, i + 1)[0][0]
              for i in BENCH_FRAMES]
    ds = cs._sequence(cs.N_FRAMES, cs.W, cs.H, 3, "forward_arc")
    return frames, np.asarray(ds.intrinsics(), np.float32)


def _pyramid(img, levels, dev):
    pyr, _ = build_pyramid_torch(torch.as_tensor(img, device=dev), levels)
    return pyr


def _levels(bench, name: str, snapped: bool, dev, points: int = 0):
    """The init_level calls (args, keywords) of one CoarseInitializer.track
    of bench frame 4 against frame 0 at ``preset(name)`` on ``dev`` (with
    ``points`` selected, if given), and the initializer; with ``snapped``,
    as after the snap."""
    frames, intr = bench
    cfg = preset(name)
    if points:
        cfg = cfg.replace(shapes=dataclasses.replace(cfg.shapes, init_points=points))
    levels = cfg.shapes.pyr_levels
    pyr0 = _pyramid(frames[0], levels, dev)
    init = init2f.CoarseInitializer(cfg, intr, dev)
    init.set_first(pyr0, [torch.sum(p[..., 1:3] ** 2, dim=-1) for p in pyr0])
    init.snapped = snapped
    kept = []
    plain = init2f.init_level

    def keep(*args, **kw):
        kept.append((cs._clone(args), cs._clone(kw)))
        return plain(*args, **kw)

    init2f.init_level = keep
    try:
        init.track(_pyramid(frames[1], levels, dev))
    finally:
        init2f.init_level = plain
    return kept, init


@pytest.fixture(scope="module")
def default_levels(bench):
    return {snapped: _levels(bench, "default", snapped, torch.device("cpu"))[0]
            for snapped in (False, True)}


@pytest.fixture(scope="module")
def wide_levels(bench):
    """The default preset's levels with 2048 points selected."""
    return {snapped: _levels(bench, "default", snapped, torch.device("cpu"), 2048)[0]
            for snapped in (False, True)}


def _case(levels, level: int, iters: int):
    """The kept call at ``level`` (its state the one track() hands it, after
    the coarser levels ran) with ``iters`` iterations."""
    args, kw = next((a, k) for a, k in levels if k["level"] == level)
    return args, dict(kw, iters=iters)


@pytest.mark.parametrize("snapped", [False, True])
def test_dispatch_takes_the_plain_version_for_cpu_tensors(default_levels, snapped):
    args, kw = _case(default_levels[snapped], 2, 8)
    before = kinit.LAUNCHES
    out = init2f.init_level(*args, **kw)
    ladder = []
    ref = init2f.init_level_torch(*args, **kw, ladder=ladder)
    assert kinit.LAUNCHES == before
    assert isinstance(out, init2f.InitLevelOut)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # the ladder records each iteration's E and trial E' and changes nothing
    assert len(ladder) == kw["iters"]
    assert all(e.dim() == 0 and t.dim() == 0 for e, t in ladder)
    assert torch.equal(ladder[-1][0] if ladder[-1][1] >= ladder[-1][0] else ladder[-1][1],
                       ref.energy)
    with pytest.raises(ValueError):
        init2f.init_level(*(a.to("meta") for a in args), **kw)


def _no_build(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the wrapper built or loaded the kernel before its checks")

    monkeypatch.setattr(cuda_build, "build", refuse)
    monkeypatch.setattr(cuda_build, "load", refuse)
    kinit._lib.cache_clear()


@pytest.mark.parametrize("case", ["cpu", "dtype", "points", "neighbours"])
def test_wrapper_refuses_before_building(default_levels, monkeypatch, case):
    _no_build(monkeypatch)
    args, kw = _case(default_levels[False], 2, 8)
    args = list(args)
    err = ValueError
    if case == "dtype":
        args[2], err = args[2].double(), TypeError
    elif case == "points":
        n = kinit.MAX_POINTS + 1
        args[1] = torch.zeros(n, 2)
        args[2], args[3] = torch.zeros(n, 8), torch.zeros(n, args[3].shape[1], dtype=torch.int32)
        args[6:9] = [torch.ones(n), torch.ones(n), torch.ones(n, dtype=torch.bool)]
    elif case == "neighbours":
        args[3] = torch.zeros(args[3].shape[0], kinit.MAX_NEIGHBORS + 1, dtype=torch.int32)
    before = kinit.LAUNCHES
    with pytest.raises(err, match={"cpu": "CUDA", "dtype": "colors", "points": "points",
                                   "neighbours": "neighbours"}[case]):
        kinit.init_level_cuda(*args, **kw)
    assert kinit.LAUNCHES == before


def test_wrapper_imports_without_nvcc():
    # nothing is built at import: no nvcc on PATH, no CUDA_HOME
    code = ("import ldso_tpu_torch.kernels.init_level as k, ldso_tpu_torch.init2f, "
            "ldso_tpu_torch.kernels.cuda_build as b; assert k.LAUNCHES == 0\n"
            "try:\n    b.nvcc()\nexcept RuntimeError:\n    pass\n"
            "else:\n    raise SystemExit('nvcc found')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=os.path.join(root, "no-cuda-here"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _source_int(name: str) -> int:
    """A ``constexpr int`` of csrc/init_level.cu whose value is a literal."""
    return int(re.search(rf"constexpr int {name} = (\d+);", open(kinit.SOURCE).read()).group(1))


def test_launch_config_picks_a_cluster_that_holds_the_points():
    # the source's limits, read off it: the most points and neighbours, the
    # threads and the cluster of a launch
    text = open(kinit.SOURCE).read()
    assert kinit.MAX_POINTS == _source_int("kMaxN") >= 4096
    assert kinit.MAX_NEIGHBORS == _source_int("kMaxK")
    assert kinit.THREADS == _source_int("kThreads")
    assert kinit.CLUSTER == _source_int("kCluster")
    assert 2 <= kinit.CLUSTER <= 8          # a portable cluster
    cta = kinit.THREADS // kinit.CLUSTER
    for n in (1, 255, 256, 512, 513, 1024, 2048, 4096, 5120, 5121, 8192, kinit.MAX_POINTS):
        assert kinit.launch_config(n) == (kinit.CLUSTER, cta)
    # a CTA's shared memory: kSlotBytes a slot (two buffers of kStateFloats
    # floats, 16 floats of rays, the median, 2 flag bytes), ceil(N / 512) x
    # cta slots, beside the static Shared (under 8 KB), within kSmemMax;
    # MAX_POINTS is the largest count that fits
    assert "constexpr int kSlotBytes = (2 * kStateFloats + 16 + 1) * 4 + 2;" in text
    slot = (2 * _source_int("kStateFloats") + 16 + 1) * 4 + 2

    def smem(n):
        return slot * -(-n // kinit.THREADS) * cta

    assert smem(kinit.MAX_POINTS) + 8192 <= _source_int("kSmemMax") < smem(kinit.MAX_POINTS + 1)
    # the main path's width (preset("default")'s 1024 points) runs on a
    # cluster of at least two CTAs
    assert kinit.launch_config(preset("default").shapes.init_points)[0] >= 2


def test_argtypes_follow_the_c_entry():
    # the ctypes binding's argument types are the C entry point's, one by
    # one (a pointer, an int, a float), read off csrc/init_level.cu
    import ctypes
    import re

    text = open(kinit.SOURCE).read()
    params = re.search(r'extern "C" int ldso_init_level\((.*?)\)\s*\{', text, re.S).group(1)
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    want = [types["p" if "*" in q else "f" if q.split()[0] == "float" else "i"]
            for q in params.replace("\n", " ").split(",")]
    assert kinit.ARGTYPES == want


@pytest.mark.parametrize("snapped", [False, True])
def test_plain_matches_jax_at_full_width(default_levels, snapped):
    """1024 points, 10 neighbours, bench frame 4 against frame 0 at level 2
    (160x120), 8 iterations: tests/test_torch_init.py::test_init_level's
    bounds, through the JAX package's own init_level. The start is the
    state track() hands level 2: from that test's random start (T0 0.1
    along z, idepths 1 +- 10%) the snapped GN is chaotic at this width,
    where one ulp of idepth0 alone moves points of the port's own result
    beyond the bounds."""
    import jax.numpy as jnp

    from ldso_tpu import init2f as jinit

    args, kw = _case(default_levels[snapped], 2, 8)
    assert args[1].shape[0] == 1024 and args[3].shape[1] == 10
    assert tuple(args[0].shape) == (120, 160, 3)
    args_np = [np.array(a.numpy()) for a in args]
    a = jinit.init_level(*map(jnp.asarray, args_np), **{k: kw[k] for k in
                                                        ("level", "iters", "snapped")})
    b = init2f.init_level_torch(*[torch.tensor(x) for x in args_np],
                                **{k: kw[k] for k in ("level", "iters", "snapped")})
    np.testing.assert_allclose(b.T.numpy(), np.asarray(a.T), atol=1e-4)
    np.testing.assert_allclose(b.idepth.numpy(), np.asarray(a.idepth), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(b.iR.numpy(), np.asarray(a.iR), rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(b.good.numpy(), np.asarray(a.good))
    np.testing.assert_allclose(float(b.energy), float(a.energy), rtol=1e-3)


@pytest.mark.parametrize("snapped", [False, True])
def test_plain_matches_jax_at_2048_points(wide_levels, snapped):
    """test_plain_matches_jax_at_full_width's case and bounds at 2048
    points (the default preset with init_points 2048): a width the kernel
    takes since it runs on a cluster of CTAs."""
    import jax.numpy as jnp

    from ldso_tpu import init2f as jinit

    args, kw = _case(wide_levels[snapped], 2, 8)
    assert args[1].shape[0] == 2048 and args[3].shape[1] == 10
    args_np = [np.array(a.numpy()) for a in args]
    a = jinit.init_level(*map(jnp.asarray, args_np), **{k: kw[k] for k in
                                                        ("level", "iters", "snapped")})
    b = init2f.init_level_torch(*[torch.tensor(x) for x in args_np],
                                **{k: kw[k] for k in ("level", "iters", "snapped")})
    np.testing.assert_allclose(b.T.numpy(), np.asarray(a.T), atol=1e-4)
    np.testing.assert_allclose(b.idepth.numpy(), np.asarray(a.idepth), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(b.iR.numpy(), np.asarray(a.iR), rtol=2e-3, atol=2e-4)
    np.testing.assert_array_equal(b.good.numpy(), np.asarray(a.good))
    np.testing.assert_allclose(float(b.energy), float(a.energy), rtol=1e-3)


def test_ladder_parting_rule():
    lad = np.array([[10.0, 9.0], [9.0, 9.5], [9.0, 8.0]], np.float32)
    assert cs.ladder_parting(lad, lad.copy()) is None
    # run b rejects iteration 1's step by a hair: a tie
    near = lad.copy()
    near[1] = [9.0, 9.0 * (1 - 5e-6)]
    near_b = lad.copy()
    near_b[1] = [9.0, 9.0 * (1 + 5e-6)]
    part = cs.ladder_parting(near, near_b)
    assert part["it"] == 1 and part["tie"] and part["rho_k"] > 0 > part["rho_p"]
    # a decision 1% apart is no tie
    far = lad.copy()
    far[1] = [9.0, 8.9]
    part = cs.ladder_parting(far, lad)
    assert part["it"] == 1 and not part["tie"]


def test_g1_compare_normalizes_the_scale():
    rng = np.random.default_rng(1)
    n = 200
    T = np.eye(4)
    T[:3, 3] = [0.1, 0.0, 0.3]
    iR = (1.0 + 0.2 * rng.random(n)).astype(np.float32)
    good = rng.random(n) > 0.1
    ra = cs.init_normalized(T, iR, iR, good)
    # the same structure at twice the depth scale: the gauge G1 leaves free
    T2 = T.copy()
    T2[:3, 3] *= 2.0
    rb = cs.init_normalized(T2, 2 * iR, 2 * iR, good)
    g = cs.g1_compare(ra, rb)
    assert g["ok"] and g["both"] == 1.0 and g["idepth"] < 1e-6 and g["rot"] < 1e-6
    assert abs(np.mean(ra["idepth"][good]) - 1.0) < 1e-6
    # a rotation of 0.01 rad is outside
    c, s = np.cos(0.01), np.sin(0.01)
    T3 = T.copy()
    T3[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    assert not cs.g1_compare(ra, cs.init_normalized(T3, iR, iR, good))["ok"]
    # fewer than 98% of the points good in both is outside
    fewer = good & (rng.random(n) > 0.05)
    assert not cs.g1_compare(ra, cs.init_normalized(T, iR, iR, fewer))["ok"]


def test_chip_smoke_chain_compare_and_bound_on_the_cpu(default_levels):
    levels = default_levels[True]
    chain = list(cs.init_level_chain(levels[:2]))
    (a0, k0, out0, lad0), (a1, k1, out1, _) = chain
    # the first level runs the kept call; the next starts from its result
    ref = init2f.init_level_torch(*levels[0][0], **levels[0][1])
    for a, b in zip(out0, ref):
        assert torch.equal(a, b)
    assert tuple(lad0.shape) == (k0["iters"], 2)
    assert a1[4] is out0.T and a1[8] is out0.good and a1[0] is levels[1][0][0]
    rec = cs.compare_init_level(out1, out1)
    assert rec["held"] and rec["e_T"] == 0 and rec["good_parted"] == 0
    # the bound of the level run as the kernel would count it
    n_ok = int(out0.good.sum()) * 8 * (1 + k0["iters"])
    fake = kinit.LevelOut(*out0, n_ok_sum=torch.tensor(n_ok), ladder=None)
    ms, by, n_bytes, flops = cs.init_level_bound_ms(a0, k0, fake)
    assert by == "operations" and 0 < ms < 1.0
    assert n_bytes > 1024 * (49 + 40) and flops > 36 * 8 * 1024 * (1 + k0["iters"])


def test_bench_probe_keeps_the_bootstrap_and_check_bootstrap_runs(bench):
    """A tiny-preset FullSystem on the CPU over the first bench frames under
    a BenchProbe: the bootstrap's set_first, track and init_level calls are
    kept, the patches are gone after it, and check_bootstrap holds two
    bootstraps on the kept pyramids (here both plain) to each other."""
    from ldso_tpu_torch.system import FullSystem

    cfg = preset("tiny")
    ds = cs._sequence(cs.N_FRAMES, cs.LOOP_W, cs.LOOP_H, 3, "forward_arc")
    frames = cs._render_frames(cs.N_FRAMES, cs.LOOP_W, cs.LOOP_H, 3, "forward_arc", 0, 14)
    probe = cs.BenchProbe((), ())
    orig = (init2f.init_level, init2f.CoarseInitializer.track,
            init2f.CoarseInitializer.set_first)
    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, device="cpu")
    statuses = []
    for i, (img, ts, expo) in enumerate(frames):
        probe.before(i)
        statuses.append(system.add_frame(img, ts, expo)["status"])
        probe.after(i)
        if statuses[-1] == "tracked":
            break
    system.shutdown()
    assert "initialized" in statuses
    n_init = statuses.index("initialized") + 1
    assert (init2f.init_level, init2f.CoarseInitializer.track,
            init2f.CoarseInitializer.set_first) == orig
    assert len(probe.boot) == n_init and "gsq" in probe.boot[0]
    assert all(len(r["levels"]) == cfg.shapes.pyr_levels for r in probe.boot[1:])
    with cs.count_bootstrap() as n:
        rec = cs.check_bootstrap(probe.boot, cfg, ds.intrinsics(), torch.device("cpu"))
    assert n[0] == 2 * (n_init - 1)
    assert rec["frames"] == n_init - 1 and rec["done"] and rec["d_good"] == 0
    assert rec["g1"]["ok"] and rec["g1"]["idepth"] == 0.0


def test_wide_init_levels_on_the_cpu(bench):
    """chip_smoke.wide_init_levels at the tiny preset on the CPU: a tracked
    bootstrap frame's levels at the asked width, chained through the plain
    version (each level starts from the plain result of the one before),
    and the bench bootstrap as scripts/torch_init_level_phases.py collects
    it."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts"))
    import torch_init_level_phases as phases

    cfg = preset("tiny")
    ds = cs._sequence(cs.N_FRAMES, cs.LOOP_W, cs.LOOP_H, 3, "forward_arc")
    frames = cs._render_frames(cs.N_FRAMES, cs.LOOP_W, cs.LOOP_H, 3, "forward_arc", 0, 14)
    boot = phases.bootstrap_levels(cs, cfg, ds, frames, torch.device("cpu"))
    assert len(boot) >= 2 and all(len(f) == cfg.shapes.pyr_levels for f in boot)
    assert boot[0][0][0][1].shape[0] == cfg.shapes.init_points
    # the records wide_init_levels reads: set_first's pyramid and gsq, then
    # the first tracked frame's pyramid
    pyr = [build_pyramid_torch(torch.as_tensor(f[0]), cfg.shapes.pyr_levels)[0]
           for f in frames[:2]]
    recs = [dict(pyr=pyr[0], gsq=[torch.sum(p[..., 1:3] ** 2, dim=-1) for p in pyr[0]]),
            dict(pyr=pyr[1])]
    n = 2 * cfg.shapes.init_points
    wide = cs.wide_init_levels(recs, cfg, ds.intrinsics(), torch.device("cpu"), n)
    assert [kw["level"] for _, kw in wide] == list(range(cfg.shapes.pyr_levels - 1, -1, -1))
    assert all(args[1].shape[0] == n and args[3].shape == (n, cfg.shapes.init_neighbors)
               for args, _ in wide)
    first = init2f.init_level_torch(*wide[0][0], **wide[0][1])
    assert torch.equal(wide[1][0][4], first.T) and torch.equal(wide[1][0][6], first.idepth)


def test_init_launch_check():
    cs._check_init_launches("t", cs.LEVELS * 6, 6)
    for launched, tracked in ((cs.LEVELS * 6 - 1, 6), (0, 0)):
        with pytest.raises(RuntimeError):
            cs._check_init_launches("t", launched, tracked)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tiny", "default"])
@pytest.mark.parametrize("snapped", [False, True])
def test_cuda_kernel_matches_plain(bench, name, snapped):
    """Every level of one bootstrap frame at the preset's shapes (tiny: 256
    points, 5 neighbours, 4 levels; default: 1024, 10, 5) and iteration
    counts, on the plain chain's inputs: chip_smoke's check (its bounds and
    tie rule, a second launch bit for bit)."""
    dev = _cuda_or_skip()
    levels, init = _levels(bench, name, snapped, dev)
    assert len(levels) == init.cfg.shapes.pyr_levels
    assert levels[0][0][1].shape[0] == init.cfg.shapes.init_points
    before = kinit.LAUNCHES
    recs = cs.check_init_frame(f"bench frame 4, {name}, snapped {snapped}", levels)
    assert kinit.LAUNCHES == before + 2 * len(levels)
    assert [r["level"] for r in recs] == list(range(len(levels) - 1, -1, -1))


@pytest.mark.gpu
@pytest.mark.parametrize("points", [1024, 2048])
@pytest.mark.parametrize("snapped", [False, True])
def test_cuda_kernel_matches_plain_at_1024_and_2048_points(bench, points, snapped):
    """Every level of one bootstrap frame at the default preset with
    ``points`` selected: chip_smoke's check against the plain version, a
    second launch bit for bit."""
    dev = _cuda_or_skip()
    levels, _ = _levels(bench, "default", snapped, dev, points)
    assert levels[0][0][1].shape[0] == points
    before = kinit.LAUNCHES
    cs.check_init_frame(f"bench frame 4, {points} points", levels)
    assert kinit.LAUNCHES == before + 2 * len(levels)


@pytest.mark.gpu
@pytest.mark.parametrize("points", [kinit.MAX_POINTS // 2, kinit.MAX_POINTS])
def test_cuda_kernel_at_the_point_cap(bench, points):
    """One level (L2, 160x120) of one bootstrap frame at the default preset
    with ``points`` selected, up to MAX_POINTS, the most the cluster's
    shared memory holds: the launch is taken (its shared memory granted),
    chip_smoke's check against the plain version holds, and a second
    launch gives the same bits."""
    dev = _cuda_or_skip()
    levels, _ = _levels(bench, "default", False, dev, points)
    assert levels[0][0][1].shape[0] == points
    before = kinit.LAUNCHES
    rec = cs.check_init_frame(f"bench frame 4, {points} points", levels[2:3])[0]
    assert kinit.LAUNCHES == before + 2 and rec["level"] == 2


@pytest.mark.gpu
def test_cuda_dispatch_launches_once_a_call_and_repeats_bitwise(bench):
    dev = _cuda_or_skip()
    levels, _ = _levels(bench, "default", True, dev)
    args, kw = levels[0]
    before = kinit.LAUNCHES
    out = init2f.init_level(*args, **kw)
    assert kinit.LAUNCHES == before + 1
    again = kinit.init_level_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert kinit.LAUNCHES == before + 2
    for a, b in zip(out, again[:8]):
        assert torch.equal(a, b)
    assert out.n_good.dtype == torch.int64 and out.good.dtype == torch.bool
    # the samples with om > 0, summed over 1 + iters evaluations
    assert 0 < int(again.n_ok_sum) <= 8 * args[1].shape[0] * (1 + kw["iters"])


@pytest.mark.gpu
def test_cuda_bootstrap_on_the_card_matches_plain(bench):
    """Two CoarseInitializer.track calls at the default preset, the kernel
    against the plain version (chip_smoke.plain_init): the same snap
    decisions and n_good within 2."""
    dev = _cuda_or_skip()
    frames, intr = bench
    cfg = preset("default")
    pyr0 = _pyramid(frames[0], cfg.shapes.pyr_levels, dev)
    pyr1 = _pyramid(frames[1], cfg.shapes.pyr_levels, dev)
    gsq = [torch.sum(p[..., 1:3] ** 2, dim=-1) for p in pyr0]
    sts = {}
    for name, ctx in (("kernel", contextlib.nullcontext()), ("plain", cs.plain_init())):
        init = init2f.CoarseInitializer(cfg, intr, dev)
        with ctx:
            init.set_first(pyr0, gsq)
            sts[name] = [init.track(pyr1) for _ in range(2)]
    for a, b in zip(sts["kernel"], sts["plain"]):
        assert (a["snapped"], a["done"]) == (b["snapped"], b["done"])
        assert abs(a["n_good"] - b["n_good"]) <= 2
