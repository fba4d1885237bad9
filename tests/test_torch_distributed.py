"""The port's distributed solvers (``ldso_tpu_torch/distributed``,
``graft_entry.py``) against the JAX package's (tests/test_distributed.py,
tests/test_multiprocess.py) on the CPU.

One module-scoped run of 4 gloo ranks executes ``chip_smoke.distributed_rank``
(the program of chip_smoke.py's phase 8) at ``preset("tiny")`` on the CPU,
two host groups of two ranks, one intra-op thread each; the ranks write
their results to a temporary directory and each test reads them. The JAX
side runs on ``make_mesh(4)`` of conftest's 8 virtual CPU devices and on
JAX's single-device solvers. Rank r holds the block device r of the JAX
mesh holds, so shards compare one to one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from ldso_tpu.ba import solve as jsolve
from ldso_tpu.ba.residuals import assemble as jassemble
from ldso_tpu.config import preset as jpreset
from ldso_tpu.core import window as jwin
from ldso_tpu.distributed import sharded_ba as jsba
from ldso_tpu.distributed import sharded_pgo as jspgo
from ldso_tpu.loop import posegraph as jpg
from ldso_tpu_torch import convert
from ldso_tpu_torch.ba.residuals import assemble
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.distributed import mesh as tmesh
from ldso_tpu_torch.distributed import sharded_pgo as tspgo
from ldso_tpu_torch.eval import toys

N_RANKS = 4
CFG = preset("tiny")
# phase 8's spec cut to the test toy: the block PGO's curve at K = 512
# (the card runs 4096); both circles of tests/test_distributed.py (the card
# runs seed 3's)
SPEC = dict(cs.DIST_SPEC, device="cpu", preset="tiny", curve=(512, 40, 6, 40),
            circle=[(0, 12, 80), (3, 15, 80)])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    """The test toy (tests/test_distributed.py's): tiny, 128x96, 3 frames."""
    win, _ = toys.make_synthetic_window(CFG, w=128, h=96, n_frames=3, idepth_noise=0.05,
                                        pose_noise=0.003, device="cpu")
    return win, convert.to_numpy(win)


@pytest.fixture(scope="module")
def ranks(toy, tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    np.savez(out / "window.npz", **toy[1])
    spec = dict(SPEC, window=str(out / "window.npz"))
    return spec, cs.run_ranks(spec, N_RANKS, "gloo", str(out), timeout_s=240,
                              ranks_per_host=2)


@pytest.fixture(scope="module")
def refs(toy, ranks):
    return cs.single_process_refs(toy[0], CFG, ranks[0], lambda: None)


def _jax_window(arrays):
    return jwin.Window(**{f: jnp.asarray(arrays[f]) for f in jwin.Window._fields})


def _energy(win):
    return float(assemble(win, huber_th=CFG.ba.huber_th,
                          outlier_sum=CFG.ba.outlier_th_sum_component).energy)


def _port_after_step(toy, results, x_key="ba_x", id_key="ba_idepth"):
    win = toy[0]
    return win._replace(x=torch.as_tensor(results[0][x_key]),
                        c=torch.as_tensor(results[0]["ba_c"]),
                        p_idepth=torch.as_tensor(np.concatenate([r[id_key] for r in results])))


def _assert_ba_close(port_win, x_ref, idepth_ref, e_ref):
    np.testing.assert_allclose(port_win.x.numpy(), x_ref, atol=3e-3)
    np.testing.assert_allclose(port_win.p_idepth.numpy(), idepth_ref, atol=5e-3)
    assert abs(_energy(port_win) - e_ref) < 0.02 * e_ref


def test_ranks_meet_the_chip_checks(toy, ranks, refs):
    # the checks phase 8 makes on the card, against the port's own single
    # process: bounds, bitwise-equal replicas, one all-reduce per step
    spec, results = ranks
    out = cs.check_distributed(results, refs, toy[0], CFG, spec)
    assert out["allreduce_floats"] == CFG.shapes.state_dim ** 2 + 2 * CFG.shapes.state_dim + 1


def test_sharded_ba_matches_jax_sharded_step(toy, ranks):
    D = CFG.shapes.state_dim
    mesh = jsba.make_mesh(N_RANKS)
    step = jsba.make_distributed_ba_step(mesh, jpreset("tiny"))
    out, E = step(jsba.shard_window(_jax_window(toy[1]), mesh), np.zeros((D, D), np.float32),
                  np.zeros(D, np.float32), lam=1e-5)
    j_out = toy[0]._replace(x=torch.as_tensor(np.array(out.x)),
                            p_idepth=torch.as_tensor(np.array(out.p_idepth)))
    _assert_ba_close(_port_after_step(toy, ranks[1]), np.array(out.x),
                     np.array(out.p_idepth), _energy(j_out))
    # the energy at the linearization point, summed over the shards
    np.testing.assert_allclose(float(ranks[1][0]["ba_E"][0]), float(E), rtol=1e-5)


def test_sharded_ba_matches_jax_single_device_step(toy, ranks):
    jw = _jax_window(toy[1])
    jc = jpreset("tiny")
    D = jc.shapes.state_dim
    sys = jassemble(jw, huber_th=jc.ba.huber_th, outlier_sum=jc.ba.outlier_th_sum_component)
    dx, dd = jsolve._solve_core(
        sys.H, sys.b, sys.H_xd, sys.H_dd, sys.b_d, jnp.zeros((D, D), jnp.float32),
        jnp.zeros(D, jnp.float32), jwin.state_delta(jw),
        jnp.asarray(jsolve.prior_diag(np.asarray(jw.frame_valid), jc), jnp.float32),
        jnp.asarray(jsolve.scale_vector(jc.shapes.max_frames, jc.scales)),
        jnp.asarray(jsolve.fix_mask(jc.shapes.max_frames, 0)), jnp.zeros(D, jnp.float32),
        jnp.float32(1e-5), jw.p_valid)
    ref = jsolve.apply_step(jw, dx, dd)
    r_win = toy[0]._replace(x=torch.as_tensor(np.array(ref.x)),
                            p_idepth=torch.as_tensor(np.array(ref.p_idepth)))
    _assert_ba_close(_port_after_step(toy, ranks[1]), np.array(ref.x), np.array(ref.p_idepth),
                     _energy(r_win))


def test_energy_decreases_over_three_steps(ranks):
    E = ranks[1][0]["ba_E"]
    assert len(E) == 3 and E[2] < E[0]


def test_each_rank_holds_its_quarter_of_the_points(toy, ranks, refs):
    B = toy[0].num_points // N_RANKS
    for r, res in enumerate(ranks[1]):
        assert int(res["n_local"]) == B
        # rank r stepped the r-th block of the bank, as device r of JAX's mesh
        np.testing.assert_allclose(res["ba_idepth"],
                                   refs["win"].p_idepth[r * B:(r + 1) * B].numpy(), atol=5e-3)


def test_one_all_reduce_of_d2_2d_1_floats_per_step(ranks):
    D = CFG.shapes.state_dim
    for res in ranks[1]:
        assert res["ba_n_calls"].tolist() == [1, 1, 1]
        assert res["ba_call_sizes"].tolist() == [D * D + 2 * D + 1] * 3 == [3721] * 3
        # on the 2x2 mesh: the same payload, within a host then across hosts
        assert res["ba2_calls"].tolist() == [3721, 3721]


def test_2d_mesh_matches_1d(toy, ranks):
    results = ranks[1]
    w1 = _port_after_step(toy, results)
    w2 = _port_after_step(toy, results, "ba2_x", "ba2_idepth")
    np.testing.assert_allclose(w2.x.numpy(), w1.x.numpy(), atol=2e-3)
    np.testing.assert_allclose(w2.p_idepth.numpy(), w1.p_idepth.numpy(), atol=5e-3)
    assert np.isfinite(results[0]["ba2_E"])


def _jax_edge_pgo(seed, lm, cg):
    _, S, ei, ej, S_meas, w, fixed = toys.sim3_circle_graph(24, seed)
    mesh = jspgo.make_mesh(N_RANKS)
    eis, ejs, Ss, ws = jspgo.shard_edges(ei, ej, S_meas.astype(np.float32),
                                         w.astype(np.float32), mesh)
    run = jspgo.make_distributed_pgo(mesh, lm_iters=lm, cg_iters=cg)
    return run(jnp.asarray(S, jnp.float32), eis, ejs, Ss, ws, jnp.asarray(fixed))


def test_edge_sharded_pgo_matches_jax_distributed(ranks):
    out = _jax_edge_pgo(0, 12, 80)
    res = ranks[1][0]
    np.testing.assert_allclose(float(res["pgo0_E"]), float(out.energy), rtol=0.05, atol=1e-8)
    np.testing.assert_allclose(res["pgo0_S"], np.array(out.S), atol=2e-3)


def test_edge_sharded_pgo_matches_port_single_process(ranks, refs):
    res = ranks[1][0]
    np.testing.assert_allclose(float(res["pgo0_E"]), refs["pgo0_E"], rtol=0.05, atol=1e-8)
    np.testing.assert_allclose(res["pgo0_S"], refs["pgo0_S"], atol=2e-3)


def test_edge_sharded_pgo_recovers_the_circle(ranks):
    gt, S, *_ = toys.sim3_circle_graph(24, 3)
    err0 = np.linalg.norm(toys.sim3_centers(S) - toys.sim3_centers(gt), axis=1).mean()
    err1 = np.linalg.norm(toys.sim3_centers(ranks[1][0]["pgo3_S"]) - toys.sim3_centers(gt),
                          axis=1).mean()
    assert err1 < 0.05 and err1 < 0.2 * err0


def test_block_pgo_at_512_against_jax_single_device(ranks):
    K, n_loops, lm, cg = SPEC["curve"]
    gt, S, ei, ej, S_meas, w, fixed = toys.sim3_curve_graph(K, n_loops)
    ref = jpg.optimize_pose_graph(jnp.asarray(S), jnp.asarray(ei), jnp.asarray(ej),
                                  jnp.asarray(S_meas), jnp.asarray(w), jnp.asarray(fixed),
                                  lm_iters=lm, cg_iters=cg)
    results = ranks[1]
    B, H = int(results[0]["block_B"]), int(results[0]["block_H"])
    assert H < B // 4, (H, B)
    e_blk = float(results[0]["block_E"])
    assert e_blk < 1.25 * float(ref.energy) + 1e-6, (e_blk, float(ref.energy))
    S_blk = np.concatenate([r["block_S"] for r in results])[:K]
    gt_c = toys.sim3_centers(gt)
    err_ref = np.linalg.norm(toys.sim3_centers(np.array(ref.S)) - gt_c, axis=1).mean()
    err_blk = np.linalg.norm(toys.sim3_centers(S_blk) - gt_c, axis=1).mean()
    assert err_blk < 1.05 * err_ref + 1e-3, (err_blk, err_ref)


def test_partition_halo_encoding():
    """Every live edge lands in its i-owner's block with a local i index;
    remote j endpoints resolve through the exporting owner's halo table."""
    K, n = 64, 4
    rng = np.random.default_rng(1)
    ei = np.concatenate([np.arange(1, K), rng.integers(K // 2, K, 6)]).astype(np.int32)
    ej = np.concatenate([np.arange(0, K - 1), rng.integers(0, K // 4, 6)]).astype(np.int32)
    S_meas = np.tile(np.eye(4, dtype=np.float32), (len(ei), 1, 1))
    part = tspgo.partition_pose_graph(K, ei, ej, S_meas, np.ones(len(ei), np.float32), n)
    B, H = part["B"], part["H"]
    assert (part["ei"] < B).all() and (part["ei"] >= 0).all()
    n_live = 0
    for d in range(n):
        for p in range(part["ei"].shape[1]):
            if part["w"][d, p] <= 0:
                continue
            n_live += 1
            enc = part["ej"][d, p]
            gi = part["ei"][d, p] + d * B
            if enc < B:
                gj = enc + d * B
            else:
                o, pos = divmod(enc - B, H)
                assert part["halo_mask"][o, pos]
                gj = part["halo_out"][o, pos] + o * B
            assert ((ei == gi) & (ej == gj)).any(), (gi, gj)
    assert n_live == len(ei)


def test_init_distributed_is_a_noop_without_the_environment(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert tmesh.init_distributed("gloo") is False


def test_init_distributed_from_the_environment(ranks):
    # every rank joined through init_distributed (spawn_ranks raises
    # otherwise), saw the others in an all-gather and, with two ranks per
    # host, built the (dcn, ici) = 2x2 mesh by default
    for res in ranks[1]:
        assert res["gathered"].ravel().tolist() == [10.0, 20.0, 30.0, 40.0]
        assert tuple(res["mesh_default"]) == (2, 2)


def test_mesh_shapes(ranks):
    for res in ranks[1]:
        assert tuple(res["mesh_rows"]) == (4, 1)
        assert "not divisible by 3 hosts" in str(res["mesh_3_error"])


def test_replicated_outputs_are_bitwise_identical_on_all_ranks(ranks):
    r0 = ranks[1][0]
    keys = ["ba_x", "ba_c", "ba_E", "ba2_x", "ba2_E", "pgo0_S", "pgo0_E", "pgo3_S", "pgo3_E",
            "block_E", "dryrun"]
    for res in ranks[1][1:]:
        for k in keys:
            np.testing.assert_array_equal(res[k], r0[k], err_msg=k)


def test_graft_entry_step_matches_root_entry():
    import __graft_entry__ as root_entry
    from ldso_tpu_torch import graft_entry

    jfn, (jw,) = root_entry.entry()
    j_out, j_E = jax.jit(jfn)(jw)
    tfn, (tw,) = graft_entry.entry(device="cpu")
    t_out, t_E = tfn(tw)
    np.testing.assert_array_equal(tw.p_uv.numpy(), np.asarray(jw.p_uv))
    np.testing.assert_allclose(float(t_E), float(j_E), rtol=1e-6)
    # The step leaves the scale gauge free (no nullspace projection, λ 1e-5),
    # so float32 LU solves of the same assembled system already part by
    # ~3e-4 in the poses (and by ~8e-5 from a float64 solve): the bounds
    # are the JAX package's for this step under another reduction order
    j_win = tw._replace(x=torch.as_tensor(np.array(j_out.x)),
                        p_idepth=torch.as_tensor(np.array(j_out.p_idepth)))
    _assert_ba_close(t_out, np.array(j_out.x), np.array(j_out.p_idepth), _energy(j_win))


def test_dryrun_multichip_in_four_ranks(ranks):
    e = ranks[1][0]["dryrun"]
    assert e.shape == (3,) and np.isfinite(e).all()


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1: exit code 1"):
        tmesh.spawn_ranks(_fail_on_rank_1, 2, backend="gloo", out_dir=str(tmp_path),
                          timeout_s=60)
    assert (tmp_path / "ok_0").exists() and not (tmp_path / "ok_1").exists()


def _fail_on_rank_1():
    if os.environ["RANK"] == "1":
        raise ValueError("rank 1 fails on purpose")


def test_torchrun_launch_of_the_dry_run(ranks):
    # the documented launch on N cards, here 2 gloo ranks on the CPU
    import json
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in tmesh.ENV_KEYS}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "localhost", "--master-port", str(tmesh._free_port()), "-m",
         "ldso_tpu_torch.graft_entry", "--backend", "gloo", "--device", "cpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["world_size"] == 2
    # the same BA energy as 4 ranks sum it, up to the order of the sum
    np.testing.assert_allclose(got["ba"], float(ranks[1][0]["dryrun"][0]), rtol=1e-5)
    assert np.isfinite([got["pgo"], got["block_pgo"]]).all()
