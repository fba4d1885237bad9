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


def test_shapes_and_crop():
    assert tpyr.level_shapes(640, 480, 5) == [(640, 480), (320, 240), (160, 120),
                                              (80, 60), (40, 30)]
    with pytest.raises(ValueError):
        tpyr.level_shapes(100, 60, 4)
    assert tpyr.crop_to_multiple(torch.zeros(61, 99), 3).shape == (60, 96)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from ldso_tpu_torch.kernels import pallas_pyramid

    img = torch.from_numpy(_image(dtype, (480, 640))).cuda()
    before = pallas_pyramid.LAUNCHES
    pyr_k, gsq_k = pallas_pyramid.build_pyramid_cuda(img, 5)
    torch.cuda.synchronize()
    assert pallas_pyramid.LAUNCHES == before + 5
    pyr_p, gsq_p = tpyr.build_pyramid_torch(img, 5)
    _compare([p.cpu() for p in pyr_k], [g.cpu() for g in gsq_k],
             [p.cpu() for p in pyr_p], [g.cpu() for g in gsq_p])
