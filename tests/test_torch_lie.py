"""math/lie.py of the port against the JAX package, on the same float32
inputs (the cases of tests/test_lie.py for SO(3)/SE(3), including the
small-angle Taylor branches and the near-π log)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldso_tpu.math import lie as jl
from ldso_tpu_torch.math import lie as tl

# float32 on both sides; sin/cos/atan2 and 3x3 products differ in the
# last ulps between XLA and torch, so 1e-5 relative / 1e-5 absolute
TOL = dict(rtol=1e-5, atol=1e-5)


def _tangents(seed=0, n=64, scale=0.5):
    rng = np.random.default_rng(seed)
    xi = (rng.normal(size=(n, 6)) * scale).astype(np.float32)
    xi[:8, 3:] *= 1e-5       # small-angle (Taylor) branch
    xi[8:12, 3:] = 0.0       # exactly zero rotation
    return xi


def _both(fn_name, x):
    a = np.asarray(getattr(jl, fn_name)(jnp.asarray(x)))
    b = getattr(tl, fn_name)(torch.tensor(x)).numpy()       # a copy: x may be read-only
    return a, b


@pytest.mark.parametrize("fn", ["so3_exp", "so3_left_jacobian", "hat"])
def test_so3_maps(fn):
    a, b = _both(fn, _tangents()[:, 3:])
    np.testing.assert_allclose(b, a, **TOL)


@pytest.mark.parametrize("fn", ["se3_exp", "se3_log_of_exp", "se3_inverse",
                                "se3_adjoint", "se3_mul"])
def test_se3_maps(fn):
    xi = _tangents(1)
    T = np.array(jl.se3_exp(jnp.asarray(xi)), np.float32)      # writable copy
    if fn == "se3_exp":
        a, b = _both("se3_exp", xi)
    elif fn == "se3_log_of_exp":
        a, b = _both("se3_log", T)
    elif fn == "se3_mul":
        a = np.asarray(jl.se3_mul(jnp.asarray(T), jnp.asarray(T[::-1])))
        b = tl.se3_mul(torch.from_numpy(T), torch.from_numpy(T[::-1].copy())).numpy()
    else:
        a, b = _both(fn, T)
    np.testing.assert_allclose(b, a, **TOL)


def test_so3_log_near_pi():
    rng = np.random.default_rng(2)
    axes = rng.normal(size=(16, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    phi = (axes * (np.pi - np.geomspace(1e-6, 1e-2, 16))[:, None]).astype(np.float32)
    R = np.asarray(jl.so3_exp(jnp.asarray(phi)), np.float32)
    a, b = _both("so3_log", R)
    # near π the log's sign/axis is ill-conditioned; both must recover phi
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b, phi, atol=5e-3)


def test_solve33():
    rng = np.random.default_rng(3)
    A = (np.eye(3) + 0.3 * rng.normal(size=(32, 3, 3))).astype(np.float32)
    y = rng.normal(size=(32, 3)).astype(np.float32)
    a = np.asarray(jl.solve33(jnp.asarray(A), jnp.asarray(y)))
    b = tl.solve33(torch.from_numpy(A), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
