"""math/lie.py of the port against the JAX package, on the same float32
inputs (the cases of tests/test_lie.py for SO(3)/SE(3), including the
small-angle Taylor branches and the near-π log; Sim(3) with its small-θ,
small-σ and both-small branches, its Jacobian at 0, and quaternions)."""

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


# ---- Sim(3) and quaternions -------------------------------------------


def _sim3_tangents(seed=4, n=64, scale=0.5):
    rng = np.random.default_rng(seed)
    tau = (rng.normal(size=(n, 7)) * scale).astype(np.float32)
    tau[:8, 3:6] *= 1e-5      # small θ (Taylor in θ)
    tau[8:16, 6] *= 1e-7      # small σ (Taylor in σ)
    tau[16:24, 3:] *= 1e-7    # both small
    tau[24:28, 3:] = 0.0      # exactly zero rotation and scale
    return tau


@pytest.mark.parametrize("fn", ["sim3_exp", "sim3_log_of_exp", "sim3_inverse",
                                "sim3_adjoint", "sim3_mul", "sim3_to_se3",
                                "sim3_scale", "sim3_rotation"])
def test_sim3_maps(fn):
    tau = _sim3_tangents()
    S = np.array(jl.sim3_exp(jnp.asarray(tau)), np.float32)    # writable copy
    if fn == "sim3_exp":
        a, b = _both("sim3_exp", tau)
    elif fn == "sim3_log_of_exp":
        a, b = _both("sim3_log", S)
    elif fn == "sim3_mul":
        a = np.asarray(jl.sim3_mul(jnp.asarray(S), jnp.asarray(S[::-1])))
        b = tl.sim3_mul(torch.from_numpy(S), torch.from_numpy(S[::-1].copy())).numpy()
    else:
        a, b = _both(fn, S)
    np.testing.assert_allclose(b, a, **TOL)


def test_sim3_unbatched_matches_batched():
    # one element at a time takes the batch-of-one path
    tau = _sim3_tangents(5, n=6)
    for x in tau:
        a = np.asarray(jl.sim3_exp(jnp.asarray(x)))
        b = tl.sim3_exp(torch.tensor(x)).numpy()
        np.testing.assert_allclose(b, a, **TOL)
        np.testing.assert_allclose(tl.sim3_log(torch.tensor(b)).numpy(),
                                   np.asarray(jl.sim3_log(jnp.asarray(a))), **TOL)


@pytest.mark.parametrize("at", ["zero", "random"])
def test_sim3_exp_jacfwd(at):
    # refine_sim3 / refine_pnp / the pose graph differentiate sim3_exp at
    # ε = 0, the Taylor branch: the Jacobian must be finite and equal JAX's
    import jax

    x = np.zeros(7, np.float32) if at == "zero" else _sim3_tangents(6, n=1)[0]
    a = np.asarray(jax.jacfwd(jl.sim3_exp)(jnp.asarray(x)))
    b = torch.func.jacfwd(tl.sim3_exp)(torch.tensor(x))
    assert b.dtype == torch.float32
    assert np.isfinite(b.numpy()).all()
    np.testing.assert_allclose(b.numpy(), a, **TOL)


def test_quaternion_round_trip():
    R = np.array(jl.so3_exp(jnp.asarray(_tangents(7)[:, 3:])), np.float32)
    a, b = _both("matrix_to_quat", R)
    np.testing.assert_allclose(b, a, **TOL)
    a2, b2 = _both("quat_to_matrix", a)
    np.testing.assert_allclose(b2, a2, **TOL)
    np.testing.assert_allclose(b2, R, atol=1e-5)
