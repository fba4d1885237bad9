"""Native C++ loader of the port (ldso_tpu_torch/native): the libpng decode
and the threaded prefetcher must agree with the pure-Python PNG decoder
and with the JAX package's loader (same source, pinned in
tests/test_torch_package.py), serve frames in order, build into ``.build/``
and say why when they cannot be built. Pixel values are compared exactly."""

import logging
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))

from torch_tum_fixture import encode_png_gray  # noqa: E402
from ldso_tpu import native as jnative  # noqa: E402
from ldso_tpu_torch import native  # noqa: E402
from ldso_tpu_torch.io import datasets  # noqa: E402


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("native loader could not be built (no g++/libpng?): "
                    f"{native.unavailable_reason()}")
    return True


def test_png_roundtrip_matches_python_decoder(built):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64), np.uint8)
    data = encode_png_gray(img)
    out = native.decode_gray(data)
    assert out is not None and out.shape == (48, 64) and out.dtype == np.float32
    np.testing.assert_array_equal(out, datasets._decode_png_gray(data))
    np.testing.assert_array_equal(out, img.astype(np.float32))
    if jnative.available():
        np.testing.assert_array_equal(out, jnative.decode_gray(data))


def test_garbage_returns_none(built):
    assert native.decode_gray(b"not an image") is None


def test_decode_image_prefers_native(built):
    assert datasets.active_decoder() == "native"
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    np.testing.assert_array_equal(datasets.decode_image(encode_png_gray(img)),
                                  img.astype(np.float32))


def test_library_is_built_beside_the_cuda_object(built):
    pkg = os.path.dirname(os.path.abspath(native.__file__))
    root = os.path.dirname(os.path.dirname(pkg))
    assert native.BUILD_DIR == os.path.join(root, ".build", "ldso_tpu_torch")
    libs = [n for n in os.listdir(native.BUILD_DIR)
            if n.startswith("libldso_native_") and n.endswith(".so")]
    assert libs, "no library in the build directory"
    assert not [n for n in os.listdir(pkg) if n.endswith(".so")], \
        "the port builds nothing into its package directory"


def test_prefetcher_serves_frames_in_order(built, tmp_path):
    rng = np.random.default_rng(1)
    paths, imgs = [], []
    for i in range(12):
        img = rng.integers(0, 256, (32, 40), np.uint8)
        p = tmp_path / f"{i:03d}.png"
        p.write_bytes(encode_png_gray(img))
        paths.append(str(p))
        imgs.append(img)
    pf = native.Prefetcher(paths, n_threads=3, ahead=4)
    try:
        assert len(pf) == 12
        for i in range(12):
            np.testing.assert_array_equal(pf.get(i), imgs[i].astype(np.float32))
    finally:
        pf.close()
    pf.close()                 # a second close is harmless


def test_build_failure_keeps_its_reason(monkeypatch, caplog):
    # a compiler that refuses: available() is False, as the contract says,
    # and the reason is kept and logged once at warning level
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", None)
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ["--no-such-flag-for-this-test"])
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available()
        assert not native.available()
        assert native.decode_gray(encode_png_gray(np.zeros((2, 2), np.uint8))) is None
    reason = native.unavailable_reason()
    assert reason and ("build failed" in reason or "g++ did not run" in reason)
    assert sum("native image loader unavailable" in r.getMessage()
               for r in caplog.records) == 1
    with pytest.raises(RuntimeError, match="unavailable"):
        native.Prefetcher([])
