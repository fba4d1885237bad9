"""[The benchmark's reference: a frozen copy of the port's module of the
same name as of its first benchmark. Every dispatcher here calls the plain
torch version on any device; where the text below speaks of kernels, it
describes the port it was copied from.]

Batched Lie-group operations: SO(3), SE(3), Sim(3) and quaternions.

Port of ``ldso_tpu/math/lie.py``. Everything is shape-batched (leading
dims broadcast) and dtype-polymorphic.

Conventions (as the reference):
  * group elements are ``[..., 4, 4]`` homogeneous matrices;
  * for Sim(3) the top-left block is ``s·R``;
  * tangent vectors follow the Sophus ordering ``[rho, phi]`` for SE(3)
    and ``[rho, phi, sigma]`` for Sim(3);
  * small-angle branches use Taylor expansions selected with
    ``torch.where`` on a safe (non-NaN-producing) formulation. The safe
    substitutions matter for ``torch.func.jacfwd``: ``torch.where``
    propagates the tangents of the branch it does not select, so a NaN
    there (0/0 at ε = 0) would poison the Jacobian.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS = 1e-8


def solve33(A, b):
    """Batched 3x3 solve via Cramer's rule. A: [..., 3, 3], b: [..., 3]."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = 1.0 / det
    x0 = (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]) * inv_det
    x1 = (c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]) * inv_det
    x2 = (c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


# ---------------------------------------------------------------------------
# so(3)
# ---------------------------------------------------------------------------


def hat(phi):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _theta_sq(phi):
    return torch.sum(phi * phi, dim=-1)


def _sinc_coeffs(theta_sq):
    """(A, B) with A = sin(t)/t, B = (1-cos(t))/t^2, Taylor-safe."""
    small = theta_sq < _EPS
    safe_tsq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_tsq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_tsq)
    return a, b


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(phi):
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    a, b = _sinc_coeffs(_theta_sq(phi))
    K = hat(phi)
    return _eye3(phi) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def matrix_to_quat(R):
    """[..., 3, 3] -> [..., 4] (x, y, z, w), branch-free (Shepperd-style)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) / 2.0
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) / 2.0
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) / 2.0
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) / 2.0
    # torch.argmax returns the first maximum, as jnp.argmax does
    case = torch.argmax(torch.stack([qw, qx, qy, qz], dim=-1), dim=-1)

    def d(q):
        return 4 * torch.clamp(q, min=1e-12)

    q_w = torch.stack([(m21 - m12) / d(qw), (m02 - m20) / d(qw),
                       (m10 - m01) / d(qw), qw], dim=-1)
    q_x = torch.stack([qx, (m01 + m10) / d(qx), (m02 + m20) / d(qx),
                       (m21 - m12) / d(qx)], dim=-1)
    q_y = torch.stack([(m01 + m10) / d(qy), qy, (m12 + m21) / d(qy),
                       (m02 - m20) / d(qy)], dim=-1)
    q_z = torch.stack([(m02 + m20) / d(qz), (m12 + m21) / d(qz), qz,
                       (m10 - m01) / d(qz)], dim=-1)
    c = case[..., None]
    q = torch.where(c == 0, q_w,
                    torch.where(c == 1, q_x, torch.where(c == 2, q_y, q_z)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def so3_log(R):
    """[..., 3, 3] -> [..., 3] via the quaternion path (accurate at 0 and pi)."""
    q = matrix_to_quat(R)
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    xyz, w = q[..., :3], q[..., 3]
    nsq = torch.sum(xyz * xyz, dim=-1)
    small = nsq < 1e-16
    n = torch.sqrt(torch.where(small, torch.ones_like(nsq), nsq))
    scale = torch.where(
        small,
        2.0 / torch.clamp(w, min=1e-12)
        * (1.0 - nsq / (3.0 * torch.clamp(w * w, min=1e-12))),
        2.0 * torch.atan2(n, w) / n,
    )
    return scale[..., None] * xyz


def so3_left_jacobian(phi):
    """V(phi): [..., 3] -> [..., 3, 3] with se3_exp translation t = V·rho."""
    tsq = _theta_sq(phi)
    small = tsq < _EPS
    safe_tsq = torch.where(small, torch.ones_like(tsq), tsq)
    theta = torch.sqrt(safe_tsq)
    b = torch.where(small, 0.5 - tsq / 24.0, (1.0 - torch.cos(theta)) / safe_tsq)
    c = torch.where(small, 1.0 / 6.0 - tsq / 120.0,
                    (theta - torch.sin(theta)) / (safe_tsq * theta))
    K = hat(phi)
    return _eye3(phi) + b[..., None, None] * K + c[..., None, None] * (K @ K)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def se3(R, t):
    """Assemble [..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]."""
    batch = tuple(np.broadcast_shapes(tuple(R.shape[:-2]), tuple(t.shape[:-1])))
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rotation(T):
    return T[..., :3, :3]


def translation(T):
    return T[..., :3, 3]


def se3_exp(xi):
    """[..., 6] tangent [rho, phi] -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = (V @ rho[..., None])[..., 0]
    return se3(R, t)


def se3_log(T):
    """[..., 4, 4] -> [..., 6] tangent [rho, phi]."""
    R = rotation(T)
    t = translation(T)
    phi = so3_log(R)
    V = so3_left_jacobian(phi)
    rho = solve33(V, t)
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T):
    R = rotation(T)
    t = translation(T)
    Rt = R.transpose(-1, -2)
    return se3(Rt, -(Rt @ t[..., None])[..., 0])


def se3_mul(A, B):
    return A @ B


def se3_adjoint(T):
    """[..., 4, 4] -> [..., 6, 6]: Adj = [[R, hat(t)·R], [0, R]]."""
    R = rotation(T)
    t = translation(T)
    tR = hat(t) @ R
    z = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([z, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------


def _batch_of_one(core_ndim: int):
    """Run an unbatched argument as a batch of one. Under ``torch.func``
    forward-mode transforms, arithmetic between a 0-dim tensor and a
    Python float gives a float64 tangent, which a later matmul with
    float32 operands refuses; with a batch axis no intermediate is 0-dim."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(x):
            if x.ndim == core_ndim:
                return fn(x[None])[0]
            return fn(x)
        return inner
    return wrap


def sim3(s, R, t):
    """Assemble [..., 4, 4] with top-left s·R."""
    return se3(s[..., None, None] * R, t)


def sim3_scale(T):
    """Recover s from the s·R block (rows of s·R have norm s)."""
    return torch.linalg.norm(T[..., 0, :3], dim=-1)


@_batch_of_one(2)
def sim3_rotation(T):
    return T[..., :3, :3] / sim3_scale(T)[..., None, None]


def _sim3_W(phi, sigma):
    """W(phi, sigma) with sim3_exp translation t = W·rho (Sophus calc_W):
    W = C·I + A·hat(phi) + B·hat(phi)², with smooth small-angle /
    small-scale limits. Every general branch is evaluated on safe
    arguments (1.0 where a Taylor branch is selected)."""
    tsq = _theta_sq(phi)
    s = torch.exp(sigma)
    sig_small = torch.abs(sigma) < 1e-5
    th_small = tsq < _EPS
    one = torch.ones_like(sigma)

    safe_sigma = torch.where(sig_small, one, sigma)
    safe_tsq = torch.where(th_small, one, tsq)
    theta = torch.sqrt(safe_tsq)          # == safe theta (1.0 where th_small)

    C = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / safe_sigma)

    # four-way branch on (sigma small, theta small)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    a_ = s * sin_t
    b_ = s * cos_t
    c_ = safe_tsq + sigma * sigma
    safe_c = torch.where(c_ < 1e-24, one, c_)

    A_gen = (a_ * sigma + (1.0 - b_) * theta) / (theta * safe_c)
    B_gen = (C - ((b_ - 1.0) * sigma + a_ * theta) / safe_c) / safe_tsq

    A_th_small = torch.where(sig_small, 0.5 + sigma / 6.0,
                             ((sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma))
    B_th_small = torch.where(
        sig_small, 1.0 / 6.0 + sigma / 24.0,
        ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0) / (safe_sigma ** 3))
    A_sig_small = (1.0 - cos_t) / safe_tsq
    B_sig_small = (theta - sin_t) / (safe_tsq * theta)

    A = torch.where(th_small, A_th_small, torch.where(sig_small, A_sig_small, A_gen))
    B = torch.where(th_small, B_th_small, torch.where(sig_small, B_sig_small, B_gen))

    K = hat(phi)
    return C[..., None, None] * _eye3(phi) + A[..., None, None] * K \
        + B[..., None, None] * (K @ K)


@_batch_of_one(1)
def sim3_exp(tau):
    """[..., 7] tangent [rho, phi, sigma] -> [..., 4, 4]."""
    rho, phi, sigma = tau[..., :3], tau[..., 3:6], tau[..., 6]
    W = _sim3_W(phi, sigma)
    return sim3(torch.exp(sigma), so3_exp(phi), (W @ rho[..., None])[..., 0])


@_batch_of_one(2)
def sim3_log(T):
    """[..., 4, 4] -> [..., 7] tangent [rho, phi, sigma]."""
    s = sim3_scale(T)
    sigma = torch.log(s)
    phi = so3_log(T[..., :3, :3] / s[..., None, None])
    rho = solve33(_sim3_W(phi, sigma), translation(T))
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


@_batch_of_one(2)
def sim3_inverse(T):
    s = sim3_scale(T)
    Rt = (T[..., :3, :3] / s[..., None, None]).transpose(-1, -2)
    s_inv = 1.0 / s
    return sim3(s_inv, Rt, -s_inv[..., None] * (Rt @ translation(T)[..., None])[..., 0])


def sim3_mul(A, B):
    return A @ B


@_batch_of_one(2)
def sim3_adjoint(T):
    """[..., 4, 4] -> [..., 7, 7], tangent order [rho, phi, sigma]:
    Adj = [[s·R, hat(t)·R, -t], [0, R, 0], [0, 0, 1]]."""
    s = sim3_scale(T)
    R = T[..., :3, :3] / s[..., None, None]
    t = translation(T)
    z3 = torch.zeros_like(R)
    z31 = torch.zeros_like(t)[..., None]
    top = torch.cat([s[..., None, None] * R, hat(t) @ R, -t[..., None]], dim=-1)
    mid = torch.cat([z3, R, z31], dim=-1)
    bottom = torch.zeros(T.shape[:-2] + (1, 7), dtype=T.dtype, device=T.device)
    bottom[..., 0, 6] = 1.0
    return torch.cat([top, mid, bottom], dim=-2)


def se3_to_sim3(T):
    """Embed an SE(3) element as Sim(3) with scale 1 (same matrix)."""
    return T


@_batch_of_one(2)
def sim3_to_se3(T):
    """Project Sim(3) -> SE(3) preserving the transform's pose: for a
    world-to-cam [sR | t] the camera center is C = −(1/s)·Rᵀ·t, and the
    SE(3) with the same center and rotation is (R, t/s)."""
    s = sim3_scale(T)
    return se3(T[..., :3, :3] / s[..., None, None], translation(T) / s[..., None])


# ---------------------------------------------------------------------------
# Quaternions (for trajectory IO — TUM format uses qx qy qz qw)
# ---------------------------------------------------------------------------


def quat_to_matrix(q):
    """[..., 4] (x, y, z, w) -> [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)
