"""Global Sim(3) pose-graph optimization.

Port of ``ldso_tpu/loop/posegraph.py``: the problem is three flat
tensors — Sim3 states [K, 4, 4], an edge list (i, j, S_meas) with static
capacity, and a fixed mask. Each Levenberg iteration evaluates the
batched edge residuals e = log(S_meas⁻¹ · S_i · S_j⁻¹), per-edge 7×7
Jacobians by forward-mode AD, and a block-Jacobi-preconditioned
conjugate-gradient solve whose matvec is two gathers and a scatter-add
over the edge list (the [7K, 7K] Hessian is never formed). The
scatter-add is ``core/scatter.SegmentSum``, a sum in a fixed order, so a
solve repeats bit for bit on the card (``index_add`` adds with atomics in
no fixed order there).

Keyframes inside the current odometry window (plus the first KF, the
gauge) are held fixed, as in the reference.

Dtype: the conductor hands in float64 (``closing.run_pose_graph``) and
this module keeps it. The JAX package computes in float64 only with its
x64 mode on (as its tests run it); without x64 it downcasts to float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ldso_tpu_torch.core.scatter import SegmentSum
from ldso_tpu_torch.math import lie


class PGOResult(NamedTuple):
    S: torch.Tensor           # [K, 4, 4] optimized Sim3 states
    energy: torch.Tensor      # scalar final Huber energy
    iterations: int


def edge_residual(S_i, S_j, S_meas_inv):
    """e = log(S_meas⁻¹ · S_i · S_j⁻¹) ∈ R⁷ (reference: EdgeSim3 error)."""
    return lie.sim3_log(lie.sim3_mul(S_meas_inv,
                                     lie.sim3_mul(S_i, lie.sim3_inverse(S_j))))


def _edge_system(S, ei, ej, S_meas_inv, w_edge, huber: float):
    """Batched residuals + Jacobians for every edge.

    Returns r [E,7], Ji [E,7,7] (∂e/∂εᵢ), Jj [E,7,7], omega [E]. One
    tangent ε [7] perturbs the i (or j) endpoint of every edge at once:
    edge e's residual depends only on its own copy, so the Jacobian of
    the stacked [E, 7] residuals with respect to ε is the per-edge one."""
    S_i, S_j = S[ei], S[ej]
    E = ei.shape[0]

    def res_i(eps):
        return edge_residual(lie.sim3_exp(eps.expand(E, 7)) @ S_i, S_j, S_meas_inv)

    def res_j(eps):
        return edge_residual(S_i, lie.sim3_exp(eps.expand(E, 7)) @ S_j, S_meas_inv)

    z = torch.zeros(7, dtype=S.dtype, device=S.device)
    r = edge_residual(S_i, S_j, S_meas_inv)
    Ji = torch.func.jacfwd(res_i)(z)
    Jj = torch.func.jacfwd(res_j)(z)

    rn = torch.linalg.norm(r, dim=-1)
    hw = torch.where(rn < huber, 1.0, huber / torch.clamp(rn, min=1e-12))
    return r, Ji, Jj, w_edge * hw


def _damping(diag, lam):
    """Per-vertex LM damping λ·max(tr(D)/7, 1e-6) + 1e-8, [K]."""
    tr = torch.diagonal(diag, dim1=-2, dim2=-1).sum(-1)
    return lam * torch.clamp(tr / 7.0, min=1e-6) + 1e-8


def _huber_energy(r, w_edge, huber: float):
    """Σ w·ρ(|r|) over the edges' [E, 7] residuals (the reference's Huber form)."""
    rn = torch.linalg.norm(r, dim=-1)
    hw = torch.where(rn < huber, 1.0, huber / torch.clamp(rn, min=1e-12))
    return torch.sum(w_edge * hw * rn * rn * (2.0 - hw))


def _cg(matvec, precond, b, x0, cg_iters: int, dot=lambda a, c: torch.sum(a * c)):
    """Preconditioned CG on (JᵀΩJ + λD)x = −b from x0, a fixed number of
    steps (``dot``: the inner product, a sum over ranks when sharded)."""
    x = x0
    rr = -b - matvec(x0)
    zz = precond(rr)
    p = zz
    for _ in range(cg_iters):
        Ap = matvec(p)
        rz = dot(rr, zz)
        alpha = rz / torch.clamp(dot(p, Ap), min=1e-20)
        x = x + alpha * p
        rr = rr - alpha * Ap
        zz = precond(rr)
        beta = dot(rr, zz) / torch.clamp(rz, min=1e-20)
        p = zz + beta * p
    return x


def _lm_update(S, S_new, lam, E_prev, E_new):
    """Accept the step iff the energy dropped: (S, λ, E) after the step."""
    accept = E_new < E_prev
    return (torch.where(accept, S_new, S),
            torch.where(accept, torch.clamp(lam * 0.5, min=1e-7), lam * 4.0),
            torch.where(accept, E_new, E_prev))


def optimize_pose_graph(
    S_init,                  # [K, 4, 4] Sim3 worldToCam
    ei, ej,                  # int [E] edge endpoints (into K)
    S_meas,                  # [E, 4, 4] measured S_i · S_j⁻¹
    w_edge,                  # [E] edge weights (0 = padding slot)
    fixed,                   # bool [K] gauge/window-fixed vertices
    lm_iters: int = 20,
    cg_iters: int = 60,
    huber: float = 0.5,
    lam0: float = 1e-4,
) -> PGOResult:
    K = S_init.shape[0]
    dt, dev = S_init.dtype, S_init.device
    ei, ej = ei.long(), ej.long()
    S_meas_inv = lie.sim3_inverse(S_meas)
    free = (~fixed)[:, None]                                       # [K, 1]
    eye = torch.eye(7, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def energy(S):
        return _huber_energy(edge_residual(S[ei], S[ej], S_meas_inv), w_edge, huber)

    seg = SegmentSum(torch.cat([ei, ej]), K)

    def scatter(a_i, a_j):
        return seg(torch.cat([a_i, a_j]))

    S = S_init
    lam = torch.as_tensor(lam0, dtype=dt, device=dev)
    E_prev = energy(S_init)
    for _ in range(lm_iters):
        r, Ji, Jj, omega = _edge_system(S, ei, ej, S_meas_inv, w_edge, huber)

        # block-diagonal (Jacobi) preconditioner + damping
        diag = scatter(torch.einsum("eab,e,eac->ebc", Ji, omega, Ji),
                       torch.einsum("eab,e,eac->ebc", Jj, omega, Jj))
        diag = diag + _damping(diag, lam)[:, None, None] * eye
        diag_inv = torch.linalg.inv(diag)
        # the reference's matvec damps with the trace of the DAMPED diagonal
        damp_mv = _damping(diag, lam)[:, None]

        b = scatter(torch.einsum("eab,e,ea->eb", Ji, omega, r),
                    torch.einsum("eab,e,ea->eb", Jj, omega, r))
        b = torch.where(free, b, zero)

        def matvec(x):
            """(JᵀΩJ + λD)x via edge gather/scatter — no dense Hessian."""
            u = (torch.einsum("eab,eb->ea", Ji, x[ei])
                 + torch.einsum("eab,eb->ea", Jj, x[ej]))
            u = omega[:, None] * u
            y = scatter(torch.einsum("eab,ea->eb", Ji, u),
                        torch.einsum("eab,ea->eb", Jj, u))
            return torch.where(free, y + damp_mv * x, zero)

        def precond(x):
            return torch.where(free, torch.einsum("kab,kb->ka", diag_inv, x), zero)

        # preconditioned CG on the normal equations
        x = _cg(matvec, precond, b, torch.zeros((K, 7), dtype=dt, device=dev), cg_iters)
        dx = torch.where(free, x, zero)

        S_new = lie.sim3_mul(lie.sim3_exp(dx), S)
        S, lam, E_prev = _lm_update(S, S_new, lam, E_prev, energy(S_new))
    return PGOResult(S=S, energy=E_prev, iterations=lm_iters)


def build_edges(pose_edges, kf_index: dict, capacity: int,
                dtype=np.float64):
    """Host helper: pack PoseEdge records into static-capacity arrays.

    kf_index maps kf_id -> vertex index. Returns (ei, ej, S_meas, w)."""
    ei = np.zeros(capacity, np.int32)
    ej = np.zeros(capacity, np.int32)
    S_meas = np.tile(np.eye(4, dtype=dtype), (capacity, 1, 1))
    w = np.zeros(capacity, dtype)
    k = 0
    for e in pose_edges:
        if e.kf_a not in kf_index or e.kf_b not in kf_index or k >= capacity:
            continue
        ei[k] = kf_index[e.kf_a]
        ej[k] = kf_index[e.kf_b]
        # T_ab is already the full measured transform: SE3 (scale 1) for
        # odometry edges, Sim3 with the scale IN the rotation block for
        # loop edges (closing.py stores S_cur_cand verbatim; the
        # PoseEdge.scale field is metadata, NOT to be re-applied)
        S_meas[k] = np.asarray(e.T_ab, dtype)
        w[k] = 5.0 if e.kind == "loop" else 1.0
        k += 1
    return ei, ej, S_meas, w
