"""Photometric calibration of the port against the JAX package's:
``tests/test_foundations.py::TestPhotometric``'s cases on both. The
calibration container and the ``pcalib.txt`` parser are numpy and must be
equal; the uint8 path is a gather (exact); the float path interpolates the
LUT in float32 (1e-5 relative to values of up to ~500)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu.io import photometric as jphoto
from ldso_tpu_torch.io import photometric as tphoto

RNG = np.random.default_rng(1)


def _gamma_lut(n=256):
    lut = np.linspace(0, 255, n).astype(np.float32) ** 1.2
    return lut / lut.max() * 255.0


def _both_calibs(lut, vignette):
    a = jphoto.PhotometricCalib.from_arrays(lut, vignette)
    b = tphoto.PhotometricCalib.from_arrays(lut, vignette)
    for f in ("inv_response", "vignette_inv"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    return a, b


def test_identity():
    raw = RNG.uniform(0, 255, size=(24, 24)).astype(np.float32)
    out = tphoto.apply_photometric(torch.from_numpy(raw), None, None)
    np.testing.assert_array_equal(out.numpy(), raw)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jphoto.apply_photometric(jnp.asarray(raw), None, None)))
    u8 = RNG.integers(0, 256, (24, 24), dtype=np.uint8)
    out = tphoto.apply_photometric(torch.from_numpy(u8), None, None)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), u8.astype(np.float32))
    assert tphoto.PhotometricCalib.identity() == tphoto.PhotometricCalib()


def test_lut_and_vignette():
    vignette = np.ones((8, 8))
    vignette[0, 0] = 0.5  # attenuated corner (max-normalization keeps the rest at 1)
    jc, tc = _both_calibs(_gamma_lut(), vignette)
    fn = tphoto.make_photometric_fn(tc, "cpu")
    out = fn(torch.full((8, 8), 128, dtype=torch.uint8))
    # vignette 0.5 at the corner -> doubles the response output there
    assert abs(float(out[0, 0]) / float(tc.inv_response[128]) - 2.0) < 1e-3
    assert abs(float(out[4, 4]) / float(tc.inv_response[128]) - 1.0) < 1e-3
    want = jphoto.make_photometric_fn(jc)(jnp.full((8, 8), 128, dtype=jnp.uint8))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_uint8_gather_is_exact_over_every_value():
    # all 256 indices, so that a uint8 index tensor read as a mask would show
    jc, tc = _both_calibs(_gamma_lut(), RNG.uniform(0.3, 1.0, (16, 16)))
    raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = tphoto.make_photometric_fn(tc, "cpu")(torch.from_numpy(raw))
    want = jphoto.make_photometric_fn(jc)(jnp.asarray(raw))
    assert got.shape == (16, 16) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_float_input_fractional_lut():
    lut = np.linspace(0, 255, 256).astype(np.float32)
    _, tc = _both_calibs(lut, None)
    out = tphoto.apply_photometric(torch.tensor([[100.5]]),
                                   torch.from_numpy(tc.inv_response), None)
    assert abs(float(out[0, 0]) - 100.5) < 1e-3


def test_float_path_matches_and_clips():
    jc, tc = _both_calibs(_gamma_lut(), RNG.uniform(0.3, 1.0, (32, 40)))
    raw = RNG.uniform(0, 255, (32, 40)).astype(np.float32)
    raw[0, :6] = [0.0, 254.0, 254.5, 255.0, 300.0, -3.0]     # the clipped ends
    got = tphoto.make_photometric_fn(tc, "cpu")(torch.from_numpy(raw)).numpy()
    want = np.asarray(jphoto.make_photometric_fn(jc)(jnp.asarray(raw)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [64, 1024])
def test_lut_resampling(n):
    # a LUT of another length is resampled to 256 entries on the host
    jc, tc = _both_calibs(_gamma_lut(n), None)
    assert tc.inv_response.shape == (256,)
    assert tc.inv_response[0] == 0.0 and tc.inv_response[-1] == pytest.approx(255.0)


def test_parse_pcalib_text():
    text = " ".join(f"{v:.6f}" for v in _gamma_lut()) + "\n"
    a, b = jphoto.parse_pcalib_text(text), tphoto.parse_pcalib_text(text)
    assert b.dtype == np.float32 and b.shape == (256,)
    np.testing.assert_array_equal(a, b)
