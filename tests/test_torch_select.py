"""select.py of the port against the JAX package: the candidate selection
is meant to be bitwise equal (same quantile formula, first-maximum cell
winners on the same layout, lower-index-first top-k ties)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu import select as jsel
from ldso_tpu.kernels import pyramid as jpyr
from ldso_tpu_torch import select as tsel
from ldso_tpu_torch.io import synthetic
from ldso_tpu_torch.kernels import pyramid as tpyr


@pytest.fixture(scope="module")
def frames():
    ds = synthetic.SyntheticDataset(w=320, h=240, n=2, seed=0, supersample=1)
    out = []
    for i in range(2):
        img = ds.get_image(i)[0].astype(np.float32)
        pj, gj = jpyr.build_pyramid_xla(jnp.asarray(img), 3)
        pt, gt = tpyr.build_pyramid_torch(torch.from_numpy(img), 3)
        out.append(((pj, gj), (pt, gt)))
    return out


@pytest.mark.parametrize("frame,num_want,seed", [(0, 256, 0), (1, 1500, 2), (1, 700, 3)])
def test_select_pixels_bitwise(frames, frame, num_want, seed):
    (pj, gj), (pt, gt) = frames[frame]
    a = jsel.select_pixels(pj[0], gj[1], gj[2], num_want=num_want, block=32, pot=5,
                           seed=seed)
    b = tsel.select_pixels(pt[0], gt[1], gt[2], num_want=num_want, block=32, pot=5,
                           seed=seed)
    np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))   # valid mask
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))   # uv
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))   # scores


def test_block_threshold_and_cell_argmax(frames):
    (pj, _), (pt, _) = frames[0]
    gsq_j = jnp.sum(pj[0][..., 1:3] ** 2, axis=-1)
    gsq_t = torch.sum(pt[0][..., 1:3] ** 2, dim=-1)
    a = np.asarray(jsel._block_quantile_threshold(gsq_j, 32, 0.5, 7.0))
    b = tsel._block_quantile_threshold(gsq_t, 32, 0.5, 7.0).numpy()
    # under the tests' x64 mode the JAX quantile runs in f64 and is cast
    # back; the port stays f32: equal to an f32 ulp
    np.testing.assert_allclose(b, a, rtol=2e-7, atol=0)
    for cell in (5, 10, 20):
        np.testing.assert_array_equal(
            tsel._cell_argmax(gsq_t, cell).numpy(),
            np.asarray(jsel._cell_argmax(gsq_j, cell)))
