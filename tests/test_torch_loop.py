"""The loop-closure stack of the port against the JAX package on the
same float32 inputs (float64 for the pose graph): Hamming matching, the
BoW vocabulary, signatures and database, Sim(3)/PnP RANSAC and GN
refinement, and the CG pose graph. RANSAC runs on the very indices that
``jax.random.choice`` draws with key 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_loop
from ldso_tpu.io.synthetic import SyntheticDataset
from ldso_tpu.kernels.pyramid import build_pyramid
from ldso_tpu.loop import bow as jbow
from ldso_tpu.loop import match as jmatch
from ldso_tpu.loop import orb as jorb
from ldso_tpu.loop import posegraph as jpg
from ldso_tpu.loop import sim3 as jsim3
from ldso_tpu.math import lie as jlie
from ldso_tpu_torch.loop import bow as tbow
from ldso_tpu_torch.loop import match as tmatch
from ldso_tpu_torch.loop import posegraph as tpg
from ldso_tpu_torch.loop import sim3 as tsim3

# RANSAC/refine outputs are 4x4 float32 transforms from SVD/eigh/solve
# chains that XLA and torch round differently: 1e-4 absolute
S_ATOL = 1e-4


def _t(a):
    return torch.tensor(np.array(a))      # owned copy of a jax/numpy buffer


def _np(a):
    return np.array(a)


@pytest.fixture(scope="module")
def feats():
    """ORB features (reference detector) of two near views and one far."""
    out = []
    for i, seed in ((0, 0), (1, 0), (0, 5)):
        ds = SyntheticDataset(w=256, h=192, n=max(i + 1, 2), seed=seed)
        img, _, _ = ds.get_image(i)
        pyr, _ = build_pyramid(jnp.asarray(img), 4)
        f = jorb.detect(pyr[0], max_features=256)
        out.append((_np(f.desc), _np(f.valid)))
    return out


def test_hamming_matrix_identical(feats):
    (da, _), (db, _), _ = feats
    a = _np(jmatch.hamming_matrix(jnp.asarray(da), jnp.asarray(db)))
    b = tmatch.hamming_matrix(_t(da), _t(db)).numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("ratio", [0.75, 1.0])
def test_match_identical(feats, ratio):
    (da, va), (db, vb), _ = feats
    ma = jmatch.match(jnp.asarray(da), jnp.asarray(va), jnp.asarray(db),
                      jnp.asarray(vb), ratio=ratio)
    mb = tmatch.match(_t(da), _t(va), _t(db), _t(vb), ratio=ratio)
    assert int(np.asarray(ma.valid).sum()) > 20
    np.testing.assert_array_equal(mb.valid.numpy(), _np(ma.valid))
    np.testing.assert_array_equal(mb.idx_b.numpy(), _np(ma.idx_b))
    np.testing.assert_array_equal(mb.dist.numpy(), _np(ma.dist))


@pytest.fixture(scope="module")
def vocabs(feats):
    descs = np.concatenate([d for d, _ in feats])
    return (jbow.train_vocabulary(descs, k=6, levels=3, seed=0),
            tbow.train_vocabulary(descs, k=6, levels=3, seed=0, device="cpu"))


def test_train_vocabulary_identical_tree(vocabs):
    va, vb = vocabs
    assert (vb.k, vb.levels, vb.n_leaves) == (va.k, va.levels, va.n_leaves)
    for ta, tb, ua, ub in zip(va.tables, vb.tables, va.table_valid, vb.table_valid):
        np.testing.assert_array_equal(tb.numpy(), _np(ta))
        np.testing.assert_array_equal(ub.numpy(), _np(ua))
    np.testing.assert_array_equal(vb.idf.numpy(), _np(va.idf))


def test_assign_leaves_identical(feats, vocabs):
    va, vb = vocabs
    for d, v in feats:
        la, pa = jbow.assign_leaves(va, jnp.asarray(d), jnp.asarray(v))
        lb, pb = tbow.assign_leaves(vb, _t(d), _t(v))
        np.testing.assert_array_equal(lb.numpy(), _np(la))
        np.testing.assert_array_equal(pb.numpy(), _np(pa))


def test_bow_vector_and_l1_score(feats, vocabs):
    va, vb = vocabs
    vecs_a = [jbow.bow_vector(va, jnp.asarray(d), jnp.asarray(v)) for d, v in feats]
    vecs_b = [tbow.bow_vector(vb, _t(d), _t(v)) for d, v in feats]
    for a, b in zip(vecs_a, vecs_b):
        # leaf weights are summed by scatter-add in another order: 1e-6
        np.testing.assert_allclose(b.numpy(), _np(a), rtol=0, atol=1e-6)
    sa = _np(jbow.l1_score(vecs_a[0], jnp.stack(vecs_a[1:])))
    sb = tbow.l1_score(vecs_b[0], torch.stack(vecs_b[1:])).numpy()
    np.testing.assert_allclose(sb, sa, rtol=0, atol=1e-6)
    assert sb[0] > sb[1] + 0.05               # same place above the far scene
    np.testing.assert_allclose(float(tbow.l1_score(vecs_b[0], vecs_b[1])),
                               float(jbow.l1_score(vecs_a[0], vecs_a[1])), atol=1e-6)


def test_keyframe_database_query(feats, vocabs):
    va, vb = vocabs
    dba, dbb = jbow.KeyframeDatabase(va), tbow.KeyframeDatabase(vb)
    for kid, (d, v) in enumerate(feats):
        dba.add(kid, jbow.bow_vector(va, jnp.asarray(d), jnp.asarray(v)))
        dbb.add(kid, tbow.bow_vector(vb, _t(d), _t(v)))
        dbb.add(kid, tbow.bow_vector(vb, _t(d), _t(v)))     # idempotent per id
    assert len(dbb) == len(dba) == 3
    d0, v0 = feats[0]
    ia, sa = dba.query(jbow.bow_vector(va, jnp.asarray(d0), jnp.asarray(v0)), exclude_above=2)
    ib, sb = dbb.query(tbow.bow_vector(vb, _t(d0), _t(v0)), exclude_above=2)
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_allclose(sb, sa, rtol=0, atol=1e-6)


# ---- Sim(3) ---------------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    """tests/test_loop.py's Sim(3) problem: 80 pairs, 25% outliers."""
    intr, S_gt, X_a, uv_a, X_b, uv_b = test_loop.TestSim3()._make_problem()
    return (np.asarray(intr, np.float32), S_gt,
            *(np.array(a, np.float32) for a in (X_a, uv_a, X_b, uv_b)))


def _reference_idx(n, n_hyps, k, valid):
    """The indices jax.random.choice draws inside ransac_* with key 0."""
    p = jnp.asarray(valid).astype(jnp.float32)
    p = p / jnp.maximum(p.sum(), 1e-9)
    return _np(jax.random.choice(jax.random.PRNGKey(0), n, shape=(n_hyps, k),
                                 replace=True, p=p))


def test_umeyama(problem):
    intr, S_gt, X_a, uv_a, X_b, uv_b = problem
    a = _np(jsim3.umeyama_sim3(jnp.asarray(X_a)[None], jnp.asarray(X_b)[None]))
    b = tsim3.umeyama_sim3(_t(X_a)[None], _t(X_b)[None]).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=S_ATOL)
    w = (np.arange(len(X_a)) % 3 != 0).astype(np.float32)
    a = _np(jsim3.umeyama_sim3(jnp.asarray(X_a), jnp.asarray(X_b), w=jnp.asarray(w)))
    b = tsim3.umeyama_sim3(_t(X_a), _t(X_b), w=_t(w)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=S_ATOL)


def _ransac_both(problem, valid):
    intr, _, X_a, uv_a, X_b, uv_b = problem
    n = len(X_a)
    key = jax.random.PRNGKey(0)
    out = {}
    ja = jsim3.ransac_sim3(*(jnp.asarray(x) for x in (X_a, uv_a, X_b, uv_b, valid, intr)),
                           key, n_hyps=128, threshold=4.0)
    tb = tsim3.ransac_sim3(*(_t(x) for x in (X_a, uv_a, X_b, uv_b, valid, intr)),
                           n_hyps=128, threshold=4.0,
                           idx=_t(_reference_idx(n, 128, 3, valid)).long())
    out["sim3"] = (ja, tb)
    ja = jsim3.ransac_pnp(*(jnp.asarray(x) for x in (X_b, uv_a, valid, intr)), key,
                          n_hyps=128)
    tb = tsim3.ransac_pnp(*(_t(x) for x in (X_b, uv_a, valid, intr)), n_hyps=128,
                          idx=_t(_reference_idx(n, 128, 6, valid)).long())
    out["pnp"] = (ja, tb)
    return valid, out


@pytest.fixture(scope="module")
def ransac_pair(problem):
    """Both RANSACs on tests/test_loop.py's setting: every pair valid."""
    return _ransac_both(problem, np.ones(len(problem[2]), bool))


@pytest.mark.parametrize("kind", ["sim3", "pnp"])
def test_ransac_on_reference_indices(ransac_pair, kind):
    _, out = ransac_pair
    ja, tb = out[kind]
    assert int(ja.n_inliers) >= 40
    np.testing.assert_array_equal(tb.inliers.numpy(), _np(ja.inliers))
    assert int(tb.n_inliers) == int(ja.n_inliers)
    np.testing.assert_allclose(tb.S_ab.numpy(), _np(ja.S_ab), rtol=0, atol=S_ATOL)


# the float32 DLT nullspace (eigh of AᵀA squares the condition number)
# sits ~1e-3 from its float64 value in BOTH packages on this problem, so
# two float32 solvers agree only to that (measured: median 1.0e-3 vs f64)
DLT_ATOL = 2e-3


@pytest.mark.parametrize("kind", ["sim3", "pnp"])
def test_ransac_sampling_follows_validity(problem, kind):
    valid = np.ones(len(problem[2]), bool)
    valid[::7] = False                         # rows that must never be sampled
    _, out = _ransac_both(problem, valid)
    ja, tb = out[kind]
    assert int(ja.n_inliers) >= 40
    np.testing.assert_array_equal(tb.inliers.numpy(), _np(ja.inliers))
    assert not tb.inliers.numpy()[::7].any()
    np.testing.assert_allclose(tb.S_ab.numpy(), _np(ja.S_ab), rtol=0,
                               atol=S_ATOL if kind == "sim3" else DLT_ATOL)


def test_refine_sim3(problem, ransac_pair):
    intr, S_gt, X_a, uv_a, X_b, uv_b = problem
    valid, out = ransac_pair
    ja, _ = out["sim3"]
    S0, inl = _np(ja.S_ab), _np(ja.inliers)
    fa = jsim3.refine_sim3(*(jnp.asarray(x) for x in (S0, X_a, uv_a, X_b, uv_b, inl,
                                                       valid, intr)))
    fb = tsim3.refine_sim3(*(_t(x) for x in (S0, X_a, uv_a, X_b, uv_b, inl, valid, intr)))
    np.testing.assert_allclose(fb.S_ab.numpy(), _np(fa.S_ab), rtol=0, atol=S_ATOL)
    np.testing.assert_array_equal(fb.inliers.numpy(), _np(fa.inliers))
    assert abs(float(np.linalg.norm(fb.S_ab.numpy()[0, :3])) - 1.3) < 0.05


def test_refine_pnp(problem, ransac_pair):
    intr, _, X_a, uv_a, X_b, uv_b = problem
    valid, out = ransac_pair
    ja, _ = out["pnp"]
    S0, inl = _np(ja.S_ab), _np(ja.inliers)
    fa = jsim3.refine_pnp(*(jnp.asarray(x) for x in (S0, X_b, uv_a, inl, valid, intr)))
    fb = tsim3.refine_pnp(*(_t(x) for x in (S0, X_b, uv_a, inl, valid, intr)))
    np.testing.assert_allclose(fb.S_ab.numpy(), _np(fa.S_ab), rtol=0, atol=S_ATOL)
    np.testing.assert_array_equal(fb.inliers.numpy(), _np(fa.inliers))


@pytest.mark.parametrize("fn", ["ransac_sim3", "ransac_pnp"])
def test_ransac_without_valid_rows_raises(problem, fn):
    intr, _, X_a, uv_a, X_b, uv_b = problem
    none = torch.zeros(len(X_a), dtype=torch.bool)
    args = ((_t(X_a), _t(uv_a), _t(X_b), _t(uv_b), none) if fn == "ransac_sim3"
            else (_t(X_b), _t(uv_a), none))
    with pytest.raises(ValueError, match="no valid correspondence"):
        getattr(tsim3, fn)(*args, _t(intr), torch.Generator().manual_seed(0))


def test_ransac_with_generator_recovers(problem):
    intr, S_gt, X_a, uv_a, X_b, uv_b = problem
    valid = torch.ones(len(X_a), dtype=torch.bool)
    r = tsim3.ransac_sim3(_t(X_a), _t(uv_a), _t(X_b), _t(uv_b), valid, _t(intr),
                          torch.Generator().manual_seed(0), n_hyps=128, threshold=4.0)
    assert int(r.n_inliers) >= 50
    assert abs(float(np.linalg.norm(r.S_ab.numpy()[0, :3])) - 1.3) < 0.05


# ---- pose graph -------------------------------------------------------------


def _drifted_circle():
    """tests/test_loop.py::TestPoseGraph's problem (same seed, same order)."""
    rng = np.random.default_rng(0)
    K = 24
    gt = []
    for i in range(K):
        th = 2 * np.pi * i / K
        Twc = np.eye(4)
        Twc[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray([0.0, th, 0.0])))
        Twc[:3, 3] = [2 * np.sin(th), 0.0, 2 * (1 - np.cos(th))]
        gt.append(np.linalg.inv(Twc))
    gt = np.stack(gt)
    S = [gt[0]]
    for i in range(1, K):
        inc = gt[i] @ np.linalg.inv(gt[i - 1])
        noise = np.asarray(jlie.sim3_exp(jnp.asarray(
            np.concatenate([rng.normal(0, 0.02, 6), [rng.normal(0, 0.01)]]))))
        S.append(noise @ inc @ S[-1])
    S = np.stack(S)
    edges = [(i, i - 1, gt[i] @ np.linalg.inv(gt[i - 1])) for i in range(1, K)]
    edges.append((K - 1, 0, gt[K - 1] @ np.linalg.inv(gt[0])))
    ei = np.asarray([e[0] for e in edges], np.int32)
    ej = np.asarray([e[1] for e in edges], np.int32)
    S_meas = np.stack([e[2] for e in edges])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return gt, S, ei, ej, S_meas, np.ones(len(edges)), fixed


def test_optimize_pose_graph_f64():
    gt, S, ei, ej, S_meas, w, fixed = _drifted_circle()
    assert S.dtype == np.float64
    a = jpg.optimize_pose_graph(*(jnp.asarray(x) for x in (S, ei, ej, S_meas, w, fixed)),
                                lm_iters=15, cg_iters=80)
    b = tpg.optimize_pose_graph(*(torch.tensor(x) for x in (S, ei, ej, S_meas, w, fixed)),
                                lm_iters=15, cg_iters=80)
    assert b.S.dtype == torch.float64
    np.testing.assert_allclose(b.S.numpy(), _np(a.S), rtol=0, atol=1e-5)
    c_est = np.stack([-(P[:3, :3].T / np.linalg.norm(P[0, :3])) @ P[:3, 3]
                      for P in b.S.numpy()])
    c_gt = np.stack([-(P[:3, :3].T) @ P[:3, 3] for P in gt])
    assert np.linalg.norm(c_est - c_gt, axis=1).mean() < 0.05


def test_edge_system_jacobians_f64():
    gt, S, ei, ej, S_meas, w, _ = _drifted_circle()
    Smi = np.array(jlie.sim3_inverse(jnp.asarray(S_meas)))
    a = jpg._edge_system(jnp.asarray(S), jnp.asarray(ei), jnp.asarray(ej),
                         jnp.asarray(Smi), jnp.asarray(w), 0.5)
    b = tpg._edge_system(torch.tensor(S), torch.tensor(ei).long(), torch.tensor(ej).long(),
                         torch.tensor(Smi), torch.tensor(w), 0.5)
    for x, y in zip(a, b):
        assert np.isfinite(y.numpy()).all()
        np.testing.assert_allclose(y.numpy(), _np(x), rtol=0, atol=1e-9)
