"""Distributed sliding-window BA: point-sharded Schur assembly.

Port of ``ldso_tpu/distributed/sharded_ba.py`` on ``torch.distributed``.
The landmark/residual set is sharded across the ranks of a mesh (rank r
holds the r-th contiguous block of the point bank), each rank linearizes
its residual shard and Schur-eliminates its own points locally (point
elimination is per-point local, so it needs no communication), and the
only collective per Gauss-Newton step is ONE all-reduce of D² + 2D + 1
floats (the reduced camera system, the undamped diagonal, the gradient
and the energy). The dense solve is replicated on every rank; idepth
backsubstitution is local to the shard.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ldso_tpu_torch.ba.residuals import assemble
from ldso_tpu_torch.ba.solve import (_fixed_scaled_solve, apply_step, fix_mask, prior_diag,
                                     prior_offset, scale_vector)
from ldso_tpu_torch.config import LdsoConfig
from ldso_tpu_torch.core.window import Window, state_delta
from ldso_tpu_torch.distributed.mesh import Mesh

AXIS = "points"   # 1-D mesh axis name the landmark bank is sharded over

# the point-indexed Window fields (sharded); the frame and camera state is
# replicated on every rank
POINT_FIELDS = ("p_valid", "p_host", "p_uv", "p_color", "p_weight", "p_idepth",
                "p_idepth_zero", "res_mask")


def shard_window(win: Window, mesh: Mesh) -> Window:
    """This rank's shard of ``win``: its contiguous block of every
    point-indexed field, the frame state whole. The point capacity must
    divide by the number of ranks."""
    P = win.num_points
    if P % mesh.size:
        raise ValueError(f"{P} points do not split over {mesh.size} ranks")
    B = P // mesh.size
    blk = slice(mesh.rank * B, (mesh.rank + 1) * B)
    return win._replace(**{f: getattr(win, f)[blk] for f in POINT_FIELDS})


def _local_gn_step(win: Window, HM, bM, prior_d, scale_vec, fixed, lam: float,
                   huber_th: float, outlier_sum: float, mesh: Mesh):
    """One GN step on this rank's shard: local residual linearization +
    local Schur elimination, one all-reduce, replicated solve, local
    backsubstitution. Returns (dx [D] replicated, dd [P_local], E)."""
    sys = assemble(win, huber_th=huber_th, outlier_sum=outlier_sum)

    delta = state_delta(win)
    Hdd_damped = sys.H_dd * (1.0 + lam) + 1e-10
    active = win.p_valid & (sys.H_dd > 1e-10)
    inv_dd = torch.where(active, 1.0 / Hdd_damped, 0.0)
    H_sc = sys.H_xd.T @ (sys.H_xd * inv_dd[:, None])
    b_sc = sys.H_xd.T @ (sys.b_d * inv_dd)

    # ONE collective of D² + 2D + 1 floats. The solver needs ΣH and ΣH_sc
    # separately only on the diagonal (damping multiplies the undamped
    # total diagonal BEFORE the Schur subtraction), so the payload carries
    # M = Σ(H − H_sc) plus diag(ΣH): the Schur diagonal is dH − diag(M)
    D = sys.H.shape[0]
    payload = torch.cat([(sys.H - H_sc).reshape(-1), torch.diagonal(sys.H),
                         sys.b - b_sc, sys.energy.reshape(1)])
    tot = mesh.psum_(payload)
    M = tot[: D * D].reshape(D, D)
    dH = tot[D * D: D * D + D]
    b_comb = tot[D * D + D: D * D + 2 * D]
    E = tot[-1]

    # replicated small solve (every rank computes the same dx); damping
    # order as the single-process solver (_solve_core): damp the undamped
    # total diagonal, THEN subtract the Schur term
    H = M + HM + torch.diag(prior_d)
    b = b_comb + bM + HM @ delta + prior_d * (delta + prior_offset(win))
    diag_f = (dH + torch.diagonal(HM) + prior_d) * (1.0 + lam) - (dH - torch.diagonal(M))
    torch.diagonal(H).copy_(diag_f)
    dx = torch.where(fixed, 0.0, _fixed_scaled_solve(H, b, scale_vec, fixed))

    # local backsubstitution for this shard's idepths
    dd = torch.where(active, -(sys.b_d + sys.H_xd @ dx) * inv_dd, 0.0)
    return dx, dd, E


def make_distributed_ba_step(mesh: Mesh, cfg: LdsoConfig, huber_th: Optional[float] = None):
    """Build the point-sharded GN step: ``full(win, HM, bM, lam=1e-5) ->
    (win', E)`` with ``win`` this rank's shard (``shard_window``), HM / bM
    the marginalization prior (replicated), E the photometric energy summed
    over all shards. One all-reduce per call on a 1-D mesh (one per axis on
    a 2-D mesh). Every rank must call it."""
    F = cfg.shapes.max_frames
    huber = float(huber_th if huber_th is not None else cfg.ba.huber_th)
    osum = float(cfg.ba.outlier_th_sum_component)
    s_vec = scale_vector(F, cfg.scales)
    fixed = fix_mask(F, 0)

    def full(win: Window, HM, bM, lam: float = 1e-5):
        dev = win.x.device
        f32 = dict(dtype=torch.float32, device=dev)
        dx, dd, E = _local_gn_step(
            win, torch.as_tensor(np.asarray(HM), **f32), torch.as_tensor(np.asarray(bM), **f32),
            prior_diag(win.frame_valid, cfg), torch.as_tensor(s_vec, device=dev),
            torch.as_tensor(fixed, device=dev), float(lam), huber, osum, mesh)
        return apply_step(win, dx, dd), E

    return full


def make_mesh(n: Optional[int] = None) -> Mesh:
    """1-D mesh over the ranks of the process group (``n``, if given, must
    be the world size: a rank outside the mesh would hold no points)."""
    return Mesh((n or torch.distributed.get_world_size(),), (AXIS,))
