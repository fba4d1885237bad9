"""Sim(3) loop-constraint estimation: batched RANSAC + GN refinement.

Port of ``ldso_tpu/loop/sim3.py``. Because both keyframes carry depth
for their matched features, the minimal solver is the 3-point
closed-form Sim(3) (Umeyama/Horn on 3D-3D correspondences); every RANSAC
hypothesis is solved in one batch, scored by symmetric reprojection, and
the winner is polished by a Huber-weighted Gauss-Newton on the 7-dof
tangent with ``torch.func.jacfwd`` Jacobians.

Hypothesis sampling draws from an explicit ``torch.Generator`` (the
reference draws with ``jax.random.choice``). Both RANSAC functions take
the sampled indices as an optional ``idx`` argument, so a test can hand
them the indices the reference drew.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ldso_tpu_torch.math import lie


class Sim3Result(NamedTuple):
    S_ab: torch.Tensor       # [4, 4] Sim3: a_cam ← b_cam
    n_inliers: torch.Tensor  # i64
    inliers: torch.Tensor    # bool [N]


def umeyama_sim3(A, B, w=None):
    """Closed-form Sim3 (a ← b) from 3D-3D pairs: A ≈ S·B.

    A, B: [..., N, 3]; optional weights [..., N]. Batched over leading
    axes (the RANSAC hypothesis axis)."""
    if w is None:
        w = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    mu_a = torch.sum(A * wn[..., None], dim=-2)
    mu_b = torch.sum(B * wn[..., None], dim=-2)
    Ac = A - mu_a[..., None, :]
    Bc = B - mu_b[..., None, :]
    cov = torch.einsum("...ni,...n,...nj->...ij", Ac, wn, Bc)
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vt)
    S_fix = torch.ones(A.shape[:-2] + (3,), dtype=A.dtype, device=A.device)
    S_fix[..., 2] = torch.sign(det)
    R = (U * S_fix[..., None, :]) @ Vt
    var_b = torch.sum(wn * torch.sum(Bc * Bc, dim=-1), dim=-1)
    s = torch.sum(D * S_fix, dim=-1) / torch.clamp(var_b, min=1e-12)
    t = mu_a - s[..., None] * (R @ mu_b[..., None])[..., 0]
    return lie.sim3(s, R, t)


def _project(X, intr):
    z = torch.clamp(X[..., 2], min=1e-6)
    return torch.stack([intr[0] * X[..., 0] / z + intr[2],
                        intr[1] * X[..., 1] / z + intr[3]], dim=-1)


def _apply(S, X):
    """S [..., 4, 4] applied to points X [N, 3] -> [..., N, 3]."""
    return torch.einsum("...ij,nj->...ni", S[..., :3, :3], X) + S[..., None, :3, 3]


def symmetric_inliers(S_ab, X_a, uv_a, X_b, uv_b, valid, intr, th: float):
    """Inlier mask under symmetric reprojection: b's points through S into
    cam a, and a's points through S⁻¹ into cam b. Batched over S_ab's
    leading axes."""
    S_ba = lie.sim3_inverse(S_ab)
    e_a = torch.linalg.norm(_project(_apply(S_ab, X_b), intr) - uv_a, dim=-1)
    e_b = torch.linalg.norm(_project(_apply(S_ba, X_a), intr) - uv_b, dim=-1)
    return valid & (e_a < th) & (e_b < th)


def _sample(valid, n_hyps: int, k: int, generator, name: str):
    """[n_hyps, k] indices drawn with replacement among the valid rows."""
    if not bool(valid.any()):
        raise ValueError(f"{name}: no valid correspondence to sample hypotheses from")
    p = valid.to(torch.float32)
    return torch.multinomial(p / p.sum(), n_hyps * k, replacement=True,
                             generator=generator).reshape(n_hyps, k)


def ransac_sim3(X_a, uv_a, X_b, uv_b, valid, intr,
                generator: Optional[torch.Generator] = None, n_hyps: int = 256,
                threshold: float = 5.0, idx=None) -> Sim3Result:
    """All hypotheses in one batch (reference ladder: solvePnPRansac's
    sequential trials → one [H, 3] gather + batched Umeyama here).
    ``idx`` [n_hyps, 3]: sampled rows; drawn from ``generator`` if None."""
    if idx is None:
        idx = _sample(valid, n_hyps, 3, generator, "ransac_sim3")
    S = umeyama_sim3(X_a[idx], X_b[idx])                          # [H, 4, 4]
    # degenerate-sample + scale sanity gate
    s = lie.sim3_scale(S)
    ok_h = torch.isfinite(s) & (s > 0.1) & (s < 10.0)

    inl = symmetric_inliers(S, X_a, uv_a, X_b, uv_b, valid, intr, threshold)  # [H, N]
    counts = torch.where(ok_h, torch.sum(inl, dim=-1), -1)
    best = torch.argmax(counts)
    S_best = S[best]
    inliers = inl[best]
    # re-fit on all inliers (weighted Umeyama) for a better starting point
    S_fit = umeyama_sim3(X_a, X_b, w=inliers.to(X_a.dtype))
    inl2 = symmetric_inliers(S_fit, X_a, uv_a, X_b, uv_b, valid, intr, threshold)
    take_fit = torch.sum(inl2) >= torch.sum(inliers)
    S_out = torch.where(take_fit, S_fit, S_best)
    inl_out = torch.where(take_fit, inl2, inliers)
    return Sim3Result(S_ab=S_out, n_inliers=torch.sum(inl_out), inliers=inl_out)


def _dlt_pose(X, uv, intr):
    """Batched DLT camera pose from ≥6 2D-3D pairs: X [..., K, 3] (world),
    uv [..., K, 2] (pixels) → [..., 4, 4] with scaled rotation (Sim3-like;
    scale absorbs the DLT's projective ambiguity residue).

    Two-rows-per-point nullspace solve. The eigenvector's sign is fixed
    afterwards by the depth test, so eigh's sign convention is free."""
    x = (uv[..., 0] - intr[2]) / intr[0]
    y = (uv[..., 1] - intr[3]) / intr[1]
    ones = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, ones[..., None]], dim=-1)                   # [..., K, 4]
    z4 = torch.zeros_like(Xh)
    row_u = torch.cat([Xh, z4, -x[..., None] * Xh], dim=-1)       # [..., K, 12]
    row_v = torch.cat([z4, Xh, -y[..., None] * Xh], dim=-1)
    A = torch.cat([row_u, row_v], dim=-2)                          # [..., 2K, 12]
    # nullspace via eigh of AᵀA (eigenvalues ascending)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    p = V[..., :, 0]                                               # [..., 12]
    P = p.reshape(*p.shape[:-1], 3, 4)
    M = P[..., :3]
    # sign: points must land in front (positive depth for the centroid)
    Xc = torch.mean(X, dim=-2)
    depth = torch.sum(M[..., 2, :] * Xc, dim=-1) + P[..., 2, 3]
    sgn = torch.where(depth < 0, -1.0, 1.0)
    P = P * sgn[..., None, None]
    M = P[..., :3]
    # orthogonalize: M = s·R with R from SVD, s = mean singular value
    U, D, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    fix = torch.ones(M.shape[:-2] + (3,), dtype=M.dtype, device=M.device)
    fix[..., 2] = torch.sign(det)
    R = (U * fix[..., None, :]) @ Vt
    s = torch.mean(D * fix, dim=-1)
    t = P[..., 3] / torch.clamp(s[..., None], min=1e-12)
    return lie.se3(R, t)


def ransac_pnp(X, uv, valid, intr, generator: Optional[torch.Generator] = None,
               n_hyps: int = 256, threshold: float = 8.0, idx=None) -> Sim3Result:
    """Batched DLT-PnP RANSAC: pose of the camera observing known 3D
    points X at pixels uv. Returns T (SE3 in a Sim3 container) mapping
    X's frame into the observing camera. ``idx`` [n_hyps, 6]: sampled
    rows; drawn from ``generator`` if None."""
    if idx is None:
        idx = _sample(valid, n_hyps, 6, generator, "ransac_pnp")
    T = _dlt_pose(X[idx], uv[idx], intr)                           # [H, 4, 4]
    Xt = _apply(T, X)                                              # [H, N, 3]
    err = torch.linalg.norm(_project(Xt, intr) - uv[None], dim=-1)
    inl = valid[None] & (err < threshold) & (Xt[..., 2] > 1e-3)
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    return Sim3Result(S_ab=T[best], n_inliers=counts[best], inliers=inl[best])


def _gn_refine(residuals, S, w_full, iters: int, huber_px: float):
    """Huber GN on the 7-dof left tangent: S ← exp(−H⁻¹b)·S, ``iters``
    times (the reference's lax.scan of the same step)."""
    eps0 = torch.zeros(7, dtype=S.dtype, device=S.device)
    eye = torch.eye(7, dtype=S.dtype, device=S.device)
    for _ in range(iters):
        r = residuals(eps0, S)
        J = torch.func.jacfwd(residuals)(eps0, S)                  # [R, 7]
        hw = torch.where(torch.abs(r) < huber_px, 1.0,
                         huber_px / torch.clamp(torch.abs(r), min=1e-9))
        om = w_full * hw
        H = torch.einsum("ri,r,rj->ij", J, om, J)
        b = torch.einsum("ri,r->i", J, om * r)
        H = H + 1e-6 * eye * torch.clamp(torch.trace(H), min=1.0)
        S = lie.sim3_mul(lie.sim3_exp(-torch.linalg.solve(H, b)), S)
    return S


def refine_pnp(S0, X, uv, inliers, valid, intr, iters: int = 10,
               huber_px: float = 3.0) -> Sim3Result:
    """GN on the 7-dof tangent for single-direction reprojection
    (2D-3D); scale is observable through projected depth."""

    def residuals(eps, S):
        Se = lie.sim3_mul(lie.sim3_exp(eps), S)
        return (_project(_apply(Se, X), intr) - uv).reshape(-1)

    w_full = torch.repeat_interleave(inliers.to(X.dtype), 2)
    S = _gn_refine(residuals, S0, w_full, iters, huber_px)
    Xs = _apply(S, X)
    err = torch.linalg.norm(_project(Xs, intr) - uv, dim=-1)
    inl = valid & (err < 2.0 * huber_px) & (Xs[..., 2] > 1e-3)
    return Sim3Result(S_ab=S, n_inliers=torch.sum(inl), inliers=inl)


def refine_sim3(S0, X_a, uv_a, X_b, uv_b, inliers, valid, intr,
                iters: int = 10, huber_px: float = 3.0) -> Sim3Result:
    """Huber GN on the 7-dof tangent, symmetric reprojection residuals
    (reference: the g2o Sim3 vertex + EdgeSim3ProjectXYZ refinement)."""

    def residuals(eps, S):
        Se = lie.sim3_mul(lie.sim3_exp(eps), S)
        r_a = _project(_apply(Se, X_b), intr) - uv_a              # [N, 2]
        r_b = _project(_apply(lie.sim3_inverse(Se), X_a), intr) - uv_b
        return torch.cat([r_a, r_b], dim=0).reshape(-1)           # [4N]

    w_full = torch.repeat_interleave(inliers.to(X_a.dtype), 2).repeat(2)   # [4N]
    S = _gn_refine(residuals, S0, w_full, iters, huber_px)
    inl = symmetric_inliers(S, X_a, uv_a, X_b, uv_b, valid, intr, huber_px * 2.0)
    return Sim3Result(S_ab=S, n_inliers=torch.sum(inl), inliers=inl)
