"""Frame input of the port against the JAX package: kernels/interp.py and
the pinhole maps of cameras.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu import cameras as jc
from ldso_tpu.kernels import interp as ji
from ldso_tpu_torch import cameras as tc
from ldso_tpu_torch.kernels import interp as ti

# the same gathers and the same bilinear formula on float32 values up to
# 255: differences are last-ulp (1.5e-5 at 255)
TOL = dict(rtol=1e-6, atol=1e-4)


def _data(seed=0, h=24, w=32, c=3, n=500):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, c)) * 255).astype(np.float32)
    # samples inside, on the border and well outside (clamped)
    uv = np.stack([rng.uniform(-3, w + 3, n), rng.uniform(-3, h + 3, n)], -1)
    return img, uv.astype(np.float32)


@pytest.mark.parametrize("channels", [None, 1, 3])
def test_bilinear(channels):
    img, uv = _data(c=channels or 1)
    if channels is None:
        img = img[..., 0]
    a = np.asarray(ji.bilinear(jnp.asarray(img), jnp.asarray(uv)))
    b = ti.bilinear(torch.from_numpy(img), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(b, a, **TOL)


def test_pack_corners_exact():
    img, _ = _data()
    a = np.asarray(ji.pack_corners(jnp.asarray(img)))
    b = ti.pack_corners(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(b, a)


def test_bilinear_packed_and_33():
    img, uv = _data(1)
    uv = uv.reshape(50, 10, 2)
    pj = ji.pack_corners(jnp.asarray(img))
    a = np.asarray(ji.bilinear_packed(pj, jnp.asarray(uv), 3))
    b = ti.bilinear_packed(ti.pack_corners(torch.from_numpy(img)), torch.from_numpy(uv),
                           3).numpy()
    np.testing.assert_allclose(b, a, **TOL)
    a33 = np.asarray(ji.bilinear33(jnp.asarray(img), jnp.asarray(uv)))
    b33 = ti.bilinear33(torch.from_numpy(img), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(b33, a33, **TOL)


def test_frame_indexed_gather_equals_per_frame():
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy((rng.random((3, 16, 20, 3)) * 255).astype(np.float32))
    uv = torch.from_numpy(rng.uniform(0, 19, (3, 40, 2)).astype(np.float32))
    frame = torch.arange(3)[:, None].expand(3, 40)
    packed = ti.pack_corners(imgs)
    got = ti.bilinear_packed(packed, uv, 3, frame=frame)
    for f in range(3):
        assert torch.equal(got[f], ti.bilinear_packed(packed[f], uv[f], 3))
        assert torch.equal(ti.bilinear(imgs, uv, frame=frame)[f], ti.bilinear(imgs[f], uv[f]))


def test_in_bounds():
    _, uv = _data(3)
    for border in (1.0, 2.0, 3.0):
        a = np.asarray(ji.in_bounds(jnp.asarray(uv), 32, 24, border))
        b = ti.in_bounds(torch.from_numpy(uv), 32, 24, border).numpy()
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("fn", ["project", "backproject", "level_intrinsics"])
def test_camera_maps(fn):
    rng = np.random.default_rng(4)
    intr = np.asarray([[420.0, 415.0, 319.5, 239.5], [300.0, 300.0, 160.0, 120.0]],
                      np.float32)
    if fn == "project":
        X = np.concatenate([rng.normal(size=(2, 50, 2)), rng.uniform(0.5, 9.0, (2, 50, 1))],
                           -1).astype(np.float32)
        args = (X, intr[:, None, :])
    elif fn == "backproject":
        args = (rng.uniform(0, 640, (2, 50, 2)).astype(np.float32),
                rng.uniform(0.05, 2.0, (2, 50)).astype(np.float32), intr[:, None, :])
    else:
        args = (intr, 3)
    a = np.asarray(getattr(jc, fn)(*[jnp.asarray(x) if isinstance(x, np.ndarray) else x
                                     for x in args]))
    b = getattr(tc, fn)(*[torch.tensor(x) if isinstance(x, np.ndarray) else x
                          for x in args]).numpy()
    # the same float32 formula: last-ulp differences at most (pixels up to ~1e4)
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-4)
