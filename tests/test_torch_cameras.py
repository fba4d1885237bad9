"""Camera models of the port against the JAX package's: the numpy half
(distortion models, remap grid, crop search, ``camera.txt`` parser) must be
EQUAL, not close; ``intr_matrix`` and ``remap_image`` run on torch and are
held to 1e-5 (float32 bilinear weights on a 0..255 image)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu import cameras as jcam
from ldso_tpu.kernels import interp as jinterp
from ldso_tpu_torch import cameras as tcam
from ldso_tpu_torch.kernels import interp as tinterp

MODELS = [
    ("fov", (0.9,)),
    ("radtan", (-0.28, 0.07, 0.0002, 0.00002)),
    ("equidistant", (-0.01, 0.02, -0.005, 0.001)),
]
W, H = 320, 240
INTR_IN = (260.0, 260.0, 159.5, 119.5)


def _calibs(model, params, out_intr=(200.0, 200.0, 159.5, 119.5)):
    args = (model, (W, H), INTR_IN, params, (W, H), out_intr)
    return jcam.CameraCalib(*args), tcam.CameraCalib(*args)


@pytest.mark.parametrize("model", sorted(jcam._DISTORT))
def test_distortion_models_equal(model):
    assert sorted(tcam._DISTORT) == sorted(jcam._DISTORT)
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-0.8, 0.8, (2, 500))
    x[:3] = y[:3] = 0.0                       # the r -> 0 branch
    params = {"pinhole": (), "fov": (0.9,), "atan": (0.7,),
              "radtan": MODELS[1][1]}.get(model, MODELS[2][1])
    for a, b in zip(jcam._DISTORT[model](x, y, params),
                    tcam._DISTORT[model](x, y, params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model,params", MODELS)
def test_remap_undistorts(model, params):
    # tests/test_foundations.py::TestDistortion::test_remap_undistorts on
    # the port, and the grid equal to the reference's
    jc, tc = _calibs(model, params)
    remap = tcam.make_remap(tc)
    assert remap.shape == (H, W, 2) and remap.dtype == np.float32
    cu, cv = remap[120, 160]
    assert abs(cu - 159.5) < 2.0 and abs(cv - 119.5) < 2.0
    assert (remap[..., 0] >= 0).mean() > 0.5
    np.testing.assert_array_equal(remap, jcam.make_remap(jc))


def test_crop_mode_all_inside():
    params = (0.9,)
    out_intr = tcam.find_crop_intrinsics("fov", (W, H), INTR_IN, params, (W, H))
    assert out_intr == jcam.find_crop_intrinsics("fov", (W, H), INTR_IN, params, (W, H))
    remap = tcam.make_remap(_calibs("fov", params, out_intr)[1])
    assert (remap[..., 0] >= 0).all(), "crop mode must keep every output pixel valid"


@pytest.mark.parametrize("model,params", MODELS[1:])
def test_crop_intrinsics_equal(model, params):
    assert tcam.find_crop_intrinsics(model, (W, H), INTR_IN, params, (W, H)) == \
        jcam.find_crop_intrinsics(model, (W, H), INTR_IN, params, (W, H))


@pytest.mark.parametrize("txt", [
    "0.5 0.8 0.5 0.5 0.9\n640 480\ncrop\n512 384\n",            # FOV, crop
    "300 300 160 120\n320 240\nfull\n320 240\n",                # pinhole, full
    "RadTan 458.654 457.296 367.215 248.375 -0.2834 0.0739 0.00019 1.76e-05\n"
    "752 480\ncrop\n640 480\n",
    "EquiDistant 0.4 0.6 0.5 0.5 -0.01 0.02 -0.005 0.001\n640 480\n"
    "0.45 0.7 0.5 0.5 0\n320 240\n",                            # explicit out intrinsics
    "KB 190.9 190.9 254.9 256.8 0.0034 0.0007 -0.002 0.0002\n512 512\nnone\n256 256\n",
], ids=["fov_crop", "pinhole_full", "radtan_crop", "equidistant_given", "kb_none"])
def test_parse_calib_text_equal(txt):
    a, b = jcam.parse_calib_text(txt), tcam.parse_calib_text(txt)
    for f in ("model", "in_size", "in_intr", "dist_params", "out_size", "out_intr"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(np.asarray(a.out_intr_array), b.out_intr_array)
    assert isinstance(b.out_intr_array, np.ndarray) and b.out_intr_array.dtype == np.float32
    c = tcam.parse_calib_text(txt, out_size=(128, 96))
    assert c.out_size == (128, 96)
    assert c.out_intr == jcam.parse_calib_text(txt, out_size=(128, 96)).out_intr


def test_parse_calib_text_cases_of_the_reference_tests():
    c = tcam.parse_calib_text("0.5 0.8 0.5 0.5 0.9\n640 480\ncrop\n512 384\n")
    assert (c.model, c.in_size, c.out_size) == ("fov", (640, 480), (512, 384))
    assert c.in_intr[0] == pytest.approx(0.5 * 640)
    c = tcam.parse_calib_text("300 300 160 120\n320 240\nfull\n320 240\n")
    assert c.model == "pinhole" and c.out_intr[0] == pytest.approx(300.0)
    with pytest.raises(ValueError, match="cannot infer camera model"):
        tcam.parse_calib_text("1 2 3 4 5 6\n320 240\nfull\n320 240\n")


def test_pinhole_calib_and_intr_matrix():
    assert tcam.pinhole_calib(64, 48, 40.0, 41.0, 31.5, 23.5) == \
        tcam.CameraCalib("pinhole", (64, 48), (40.0, 41.0, 31.5, 23.5), (), (64, 48),
                         (40.0, 41.0, 31.5, 23.5))
    intr = np.asarray([[400.0, 410.0, 319.5, 239.5], [200.0, 205.0, 159.5, 119.5]],
                      np.float32)
    np.testing.assert_array_equal(np.asarray(jcam.intr_matrix(jnp.asarray(intr))),
                                  tcam.intr_matrix(torch.from_numpy(intr)).numpy())


@pytest.mark.parametrize("model,params", MODELS)
def test_remap_image_matches(model, params):
    # |err| <= 1e-5 on a seeded 0..255 image; the out-of-view pixels are 0
    # and nothing is NaN where the grid says -1
    remap = tcam.make_remap(_calibs(model, params, (150.0, 150.0, 159.5, 119.5))[1])
    assert (remap[..., 0] < 0).any() and (remap[..., 0] >= 0).any()
    img = np.random.default_rng(7).uniform(0, 255, (H, W)).astype(np.float32)
    want = np.asarray(jinterp.remap_image(jnp.asarray(img), jnp.asarray(remap)))
    got = tinterp.remap_image(torch.from_numpy(img), torch.from_numpy(remap)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got[remap[..., 0] < 0] == 0).all()
