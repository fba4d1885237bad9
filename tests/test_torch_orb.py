"""loop/orb.py of the port against the JAX package: FAST and Shi-Tomasi
scores, grid detection, orientation and rotated-BRIEF descriptors on
the same float32 level-0 stack (the 256x192 synthetic frame of
tests/test_loop.py), plus a frame built so that many cells tie."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu.io.synthetic import SyntheticDataset
from ldso_tpu.kernels.pyramid import build_pyramid
from ldso_tpu.loop import orb as jorb
from ldso_tpu_torch.loop import orb as torb

# FAST scores are exact integer-valued differences on both sides; the
# Shi-Tomasi fallback and the orientation sums round differently in the
# last ulps, so 1e-4 absolute on scores and angles
SCORE_ATOL = 1e-4
ANGLE_ATOL = 1e-4


@pytest.fixture(scope="module")
def level0():
    ds = SyntheticDataset(w=256, h=192, n=2)
    img, _, _ = ds.get_image(0)
    pyr, _ = build_pyramid(jnp.asarray(img), 4)
    # an owned copy: a numpy view of a jax buffer is not guaranteed to
    # stay unchanged after the jax array is released
    return np.array(pyr[0], np.float32)


def _t(a):
    return torch.tensor(a)            # a copy: numpy views of jax arrays are read-only


def test_fast_score(level0):
    img = level0[..., 0]
    a = np.asarray(jorb.fast_score(jnp.asarray(img), threshold=20.0))
    b = torb.fast_score(_t(img), threshold=20.0).numpy()
    assert (a > 0).sum() > 100
    np.testing.assert_allclose(b, a, rtol=0, atol=SCORE_ATOL)


def test_shi_tomasi_score(level0):
    a = np.asarray(jorb.shi_tomasi_score(jnp.asarray(level0[..., 1]),
                                         jnp.asarray(level0[..., 2])))
    b = torb.shi_tomasi_score(_t(level0[..., 1]), _t(level0[..., 2])).numpy()
    # scores reach ~1e3 (squared 8-bit gradients): 1e-5 relative
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=SCORE_ATOL)


@pytest.mark.parametrize("max_features", [256, 2048])
def test_detect(level0, max_features):
    # 2048 > the 192 cells: the padded tail must agree too
    fa = jorb.detect(jnp.asarray(level0), max_features=max_features)
    fb = torb.detect(_t(level0), max_features=max_features)
    np.testing.assert_array_equal(fb.uv.numpy(), np.asarray(fa.uv))
    np.testing.assert_array_equal(fb.valid.numpy(), np.asarray(fa.valid))
    np.testing.assert_allclose(fb.score.numpy(), np.asarray(fa.score), rtol=0,
                               atol=SCORE_ATOL)
    v = np.asarray(fa.valid)
    assert v.sum() > 100
    np.testing.assert_allclose(fb.angle.numpy()[v], np.asarray(fa.angle)[v], rtol=0,
                               atol=ANGLE_ATOL)
    # a tiny angle difference can flip a BRIEF comparison that sits on a
    # tie: ≥ 99% of the valid descriptors bit-identical, none > 2 bits off
    bits_a = np.unpackbits(np.asarray(fa.desc), axis=1)[v]
    bits_b = np.unpackbits(fb.desc.numpy(), axis=1)[v]
    n_diff = (bits_a != bits_b).sum(axis=1)
    assert (n_diff == 0).mean() >= 0.99, n_diff
    assert n_diff.max() <= 2, n_diff
    assert fb.desc.dtype == torch.uint8 and fb.desc.shape == (max_features, 32)


def test_detect_tie_order():
    # the same bright square in every 16x16 cell: every interior cell has
    # the same best score, so the top-k is decided by the tie order alone
    # (jax.lax.top_k: lower index first)
    cell = np.full((16, 16), 60.0, np.float32)
    cell[6:10, 6:10] = 200.0
    img = np.tile(cell, (8, 10))                                  # 128 x 160
    pyr, _ = build_pyramid(jnp.asarray(img), 1)
    stack = np.array(pyr[0], np.float32)
    fa = jorb.detect(jnp.asarray(stack), max_features=12)
    fb = torb.detect(_t(stack), max_features=12)
    top = np.asarray(fa.score)
    assert (top == top[0]).all() and top[0] > 1e3                # all tied FAST hits
    np.testing.assert_array_equal(fb.uv.numpy(), np.asarray(fa.uv))
    np.testing.assert_array_equal(fb.score.numpy(), top)


def test_unpack_bits():
    rng = np.random.default_rng(0)
    d = rng.integers(0, 256, size=(5, 32), dtype=np.uint8)
    np.testing.assert_array_equal(torb.unpack_bits(_t(d)).numpy(),
                                  np.asarray(jorb.unpack_bits(jnp.asarray(d))))
