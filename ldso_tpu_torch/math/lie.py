"""Batched Lie-group operations: SO(3) and SE(3).

Port of ``ldso_tpu/math/lie.py``. Everything is shape-batched (leading
dims broadcast) and dtype-polymorphic.

Conventions (as the reference):
  * group elements are ``[..., 4, 4]`` homogeneous matrices;
  * SE(3) tangent vectors follow the Sophus ordering ``[rho, phi]``;
  * small-angle branches use Taylor expansions selected with
    ``torch.where`` on a safe (non-NaN-producing) formulation.
"""

from __future__ import annotations

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


def _matrix_to_quat(R):
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
    q = _matrix_to_quat(R)
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
