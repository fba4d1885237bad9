"""``core/scatter.SegmentSum``, the fixed-order scatter-add of the pose
graphs, against ``index_add``, and its use in the port's pose graph."""

import numpy as np
import pytest
import torch

from ldso_tpu_torch.core.scatter import SegmentSum
from ldso_tpu_torch.eval import toys
from ldso_tpu_torch.loop.posegraph import optimize_pose_graph

# the same terms summed in another order: 1e-6 relative to the row's scale
RTOL = 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("row_shape", [(), (7,), (7, 7)], ids=["scalar", "vec7", "mat7x7"])
def test_segment_sum_equals_index_add(dtype, row_shape):
    rng = np.random.default_rng(4)
    n, e = 40, 300
    # skewed indices, and rows 0 and n - 1 left empty
    idx = torch.from_numpy(np.clip(rng.geometric(0.08, e), 1, n - 2))
    rows = torch.from_numpy(rng.standard_normal((e,) + row_shape)).to(dtype)
    want = torch.zeros((n,) + row_shape, dtype=dtype).index_add(0, idx, rows)
    got = SegmentSum(idx, n)(rows)
    assert got.shape == want.shape and got.dtype == dtype
    scale = torch.zeros((n,) + row_shape, dtype=dtype).index_add(0, idx, rows.abs())
    assert bool(((got - want).abs() <= RTOL * scale).all())
    assert not bool(got[0].any()) and not bool(got[-1].any())
    # and again: the same bits
    assert torch.equal(SegmentSum(idx, n)(rows), got)


def test_pose_graph_solve_repeats_bit_for_bit():
    _, S, ei, ej, S_meas, w, fixed = toys.sim3_curve_graph(256, 10)
    args = [torch.from_numpy(np.asarray(a)) for a in (S, ei, ej, S_meas, w, fixed)]
    a = optimize_pose_graph(*args, lm_iters=4, cg_iters=20)
    b = optimize_pose_graph(*args, lm_iters=4, cg_iters=20)
    assert torch.equal(a.S, b.S) and torch.equal(a.energy, b.energy)
    assert bool(torch.isfinite(a.energy))
