"""The pyramid build of the port against the JAX package's XLA and Pallas
builds, and the CUDA kernel against the port's plain version.

The JAX package is imported inside the tests that use it, so that this
file also runs on a machine with a card and no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_pyramid.py``.
"""

import numpy as np
import pytest
import torch

from ldso_tpu_torch.kernels import pyramid as tpyr

# Same bounds as the JAX package's Pallas-vs-XLA check
# (tests/test_frontend.py::TestPallasPyramid): the 2x2 means may be summed
# in another order (an ulp of 255 is 1.5e-5), and gsq squares gradients
# up to ~127, so a one-ulp input difference moves it by more than 1e-3.
PYR_TOL = dict(rtol=1e-6, atol=1e-4)
GSQ_TOL = dict(rtol=1e-6, atol=1e-3)


def _image(dtype=np.float32, shape=(96, 128), seed=7):
    rng = np.random.default_rng(seed)
    img = rng.random(shape, np.float32) * 255.0
    return img.astype(np.uint8) if dtype == np.uint8 else img


def _compare(pyr_a, gsq_a, pyr_b, gsq_b):
    assert len(pyr_a) == len(pyr_b)
    for l in range(len(pyr_a)):
        np.testing.assert_allclose(np.asarray(pyr_a[l]), np.asarray(pyr_b[l]), **PYR_TOL)
        np.testing.assert_allclose(np.asarray(gsq_a[l]), np.asarray(gsq_b[l]), **GSQ_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_plain_matches_xla(dtype):
    from ldso_tpu.kernels import pyramid as jpyr

    img = _image(dtype)
    pyr_j, gsq_j = jpyr.build_pyramid_xla(img, 4)
    pyr_t, gsq_t = tpyr.build_pyramid_torch(torch.from_numpy(img), 4)
    _compare(pyr_t, gsq_t, pyr_j, gsq_j)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_plain_matches_pallas_interpret(dtype):
    from ldso_tpu.kernels.pallas_pyramid import build_pyramid_pallas

    img = _image(dtype)
    pyr_p, gsq_p = build_pyramid_pallas(img, 4, interpret=True)
    pyr_t, gsq_t = tpyr.build_pyramid_torch(torch.from_numpy(img), 4)
    _compare(pyr_t, gsq_t, pyr_p, gsq_p)


# 208x176 at 5 levels: neither side is a multiple of the kernel's 64x32
# tile, and the widths of levels 3 and 4 (26, 13) are not multiples of 4
BATCH_SHAPES = [(96, 128, 4), (176, 208, 5)]


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("shape", BATCH_SHAPES, ids=lambda s: f"{s[1]}x{s[0]}")
def test_batched_plain_matches_xla_per_frame(dtype, shape):
    from ldso_tpu.kernels import pyramid as jpyr

    h, w, levels = shape
    imgs = np.stack([_image(dtype, (h, w), seed=s) for s in range(3)])
    pyr_t, gsq_t = tpyr.build_pyramid_torch(torch.from_numpy(imgs), levels)
    assert [tuple(p.shape) for p in pyr_t] == [(3, h >> l, w >> l, 3) for l in range(levels)]
    assert [tuple(g.shape) for g in gsq_t] == [(3, h >> l, w >> l) for l in range(levels)]
    for b in range(3):
        pyr_j, gsq_j = jpyr.build_pyramid_xla(imgs[b], levels)
        _compare([p[b] for p in pyr_t], [g[b] for g in gsq_t], pyr_j, gsq_j)
        # and bitwise what the plain version gives for the frame alone
        pyr_1, gsq_1 = tpyr.build_pyramid_torch(torch.from_numpy(imgs[b]), levels)
        for a, c in zip(pyr_1 + gsq_1, [p[b] for p in pyr_t] + [g[b] for g in gsq_t]):
            assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_batched_plain_matches_pallas_interpret(dtype):
    from ldso_tpu.kernels.pallas_pyramid import build_pyramid_pallas

    imgs = np.stack([_image(dtype, seed=s) for s in range(2)])
    pyr_t, gsq_t = tpyr.build_pyramid_torch(torch.from_numpy(imgs), 4)
    for b in range(2):
        pyr_p, gsq_p = build_pyramid_pallas(imgs[b], 4, interpret=True)
        _compare([p[b] for p in pyr_t], [g[b] for g in gsq_t], pyr_p, gsq_p)


def test_dispatch_takes_plain_version_for_cpu_tensors():
    img = torch.from_numpy(_image(np.uint8, (64, 64)))
    pyr, gsq = tpyr.build_pyramid(img, 3)
    pyr_p, gsq_p = tpyr.build_pyramid_torch(img, 3)
    for a, b in zip(pyr + gsq, pyr_p + gsq_p):
        assert torch.equal(a, b)


def test_cuda_wrapper_refuses_cpu_tensors():
    from ldso_tpu_torch.kernels import pallas_pyramid

    with pytest.raises(ValueError):
        pallas_pyramid.build_pyramid_cuda(torch.zeros(32, 32), 3)
    with pytest.raises(ValueError):
        pallas_pyramid.build_pyramid_cuda(torch.zeros(2, 32, 32), 3)


def test_shapes_and_crop():
    assert tpyr.level_shapes(640, 480, 5) == [(640, 480), (320, 240), (160, 120),
                                              (80, 60), (40, 30)]
    with pytest.raises(ValueError):
        tpyr.level_shapes(100, 60, 4)
    assert tpyr.crop_to_multiple(torch.zeros(61, 99), 3).shape == (60, 96)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_cuda_kernel_matches_plain(dtype):
    # one launch per call, B = 1 and B = 8, at 640x480 and at the
    # partial-tile size
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from ldso_tpu_torch.kernels import pallas_pyramid

    for h, w in ((480, 640), (176, 208)):
        for batch in (None, 8):
            shape = (h, w) if batch is None else (batch, h, w)
            img = torch.from_numpy(_image(dtype, shape)).cuda()
            before = pallas_pyramid.LAUNCHES
            pyr_k, gsq_k = pallas_pyramid.build_pyramid_cuda(img, 5)
            torch.cuda.synchronize()
            assert pallas_pyramid.LAUNCHES == before + 1
            pyr_p, gsq_p = tpyr.build_pyramid_torch(img, 5)
            assert pyr_k[0].shape == shape + (3,) and gsq_k[4].shape == shape[:-2] + (
                h >> 4, w >> 4)
            _compare([p.cpu() for p in pyr_k], [g.cpu() for g in gsq_k],
                     [p.cpu() for p in pyr_p], [g.cpu() for g in gsq_p])


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(480, 640), (240, 320), (96, 128)])
def test_cuda_kernel_one_level_float32(h, w):
    # the toy windows (eval/toys.py) build each frame at one level from
    # float32: the kernel's one-level branch, one launch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from ldso_tpu_torch.kernels import pallas_pyramid

    img = torch.from_numpy(_image(np.float32, (h, w))).cuda()
    before = pallas_pyramid.LAUNCHES
    pyr_k, gsq_k = pallas_pyramid.build_pyramid_cuda(img, 1)
    torch.cuda.synchronize()
    assert pallas_pyramid.LAUNCHES == before + 1
    assert len(pyr_k) == 1 and pyr_k[0].shape == (h, w, 3) and gsq_k[0].shape == (h, w)
    pyr_p, gsq_p = tpyr.build_pyramid_torch(img, 1)
    _compare([p.cpu() for p in pyr_k], [g.cpu() for g in gsq_k],
             [p.cpu() for p in pyr_p], [g.cpu() for g in gsq_p])
