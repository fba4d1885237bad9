"""The port's toy builders (ldso_tpu_torch/eval/toys.py) against the JAX
package's: the synthetic BA window (ldso_tpu/eval/toys.py) and the pose
graphs of tests/test_distributed.py."""

import numpy as np
import pytest
import torch

from ldso_tpu.config import preset as jpreset
from ldso_tpu.eval import toys as jtoys
from ldso_tpu_torch import convert
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.eval import toys as ttoys

# the module, not its classes: a test class imported by name is collected here too
import test_distributed as jdist  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [dict(), dict(n_points=100, seed=1, idepth_noise=0.05,
                                             pose_noise=0.003)])
def test_synthetic_window_matches_jax(kw):
    jw, jds = jtoys.make_synthetic_window(jpreset("tiny"), w=128, h=96, n_frames=3, **kw)
    tw, tds = ttoys.make_synthetic_window(preset("tiny"), w=128, h=96, n_frames=3,
                                          device="cpu", **kw)
    got = convert.to_numpy(tw)
    # the same draws pick the same pixels
    np.testing.assert_array_equal(got["p_uv"], np.asarray(jw.p_uv))
    for f in tw._fields:
        want = np.asarray(getattr(jw, f))
        assert got[f].dtype == want.dtype and got[f].shape == want.shape, f
        if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got[f], want, err_msg=f)
        else:
            np.testing.assert_allclose(got[f], want, rtol=1e-5, atol=0, err_msg=f)
    np.testing.assert_array_equal(tds.gt_pose_c_w(2), jds.gt_pose_c_w(2))


@pytest.mark.parametrize("seed", [0, 3])
def test_circle_graph_matches_jax_test_graph(seed):
    jax_graph = jdist.TestShardedPGO()._toy_graph(seed=seed)
    for a, b in zip(ttoys.sim3_circle_graph(24, seed), jax_graph):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_curve_graph_matches_jax_test_graph():
    # the JAX builder takes Sim(3) noise in float32, the port's in float64
    # then rounds: the chained poses part by float32 ulps over 64 steps
    for a, b in zip(ttoys.sim3_curve_graph(64, 4), jdist.TestBlockPGO()._big_graph(64, 4)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_sim3_centers_undo_scale():
    rng = np.random.default_rng(0)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    C = rng.normal(size=3)
    S = np.eye(4)
    S[:3, :3] = 2.5 * R
    S[:3, 3] = -2.5 * R @ C
    np.testing.assert_allclose(ttoys.sim3_centers(S[None])[0], C, atol=1e-12)
