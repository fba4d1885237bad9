"""Distributed global Sim(3) pose graph on ``torch.distributed``.

Port of ``ldso_tpu/distributed/sharded_pgo.py``, two solvers:

* **Edge-sharded** (``make_distributed_pgo``): the edge list is sorted by
  its owning keyframe and split into contiguous per-rank shards; each rank
  linearizes its shard (the batched Sim(3) Jacobians, the dominant cost)
  and vertex-sized [K, 7] vectors are summed with one all-reduce. Per LM
  iteration: one all-reduce of [K, 56] (block-Jacobi preconditioner +
  gradient), one of [K, 7] per CG matvec (the one on x0 included) and a
  scalar per energy. The [7K, 7K] Hessian is never formed.
* **Block-halo** (``partition_pose_graph`` + ``make_block_pgo``): the
  vertex states are block-row partitioned, rank r owning B = Kp/n
  contiguous keyframes and the edges whose i endpoint it owns; only HALO
  rows (owned rows that other blocks' edges reference) move: an
  all-gather of the halo buffers, the reverse contributions with an
  all-to-all, and scalar all-reduces for CG's dot products. Per CG
  iteration the bytes are proportional to the cross-block halo H, not K.

Both run in the dtype of ``S_init``. Every accept/reject decision, λ and
CG's α and β derive from all-reduced values, so every rank takes the same
path and the replicated results agree bitwise across ranks. Every rank
must call the solver.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ldso_tpu_torch.distributed.mesh import Mesh
from ldso_tpu_torch.loop.posegraph import (PGOResult, _cg, _damping, _edge_system,
                                           _huber_energy, _lm_update, edge_residual)
from ldso_tpu_torch.math import lie

AXIS = "kf"   # mesh axis name the edge list (KF blocks) is sharded over


def _psum_scalar(mesh: Mesh, x):
    return mesh.psum_(x.reshape(1))[0]


def _edge_blocks(r, Ji, Jj, omega):
    """Per edge [E, 56] rows (the 7×7 diagonal block, then the gradient)
    for the i and the j endpoint."""
    Hii = torch.einsum("eab,e,eac->ebc", Ji, omega, Ji)
    Hjj = torch.einsum("eab,e,eac->ebc", Jj, omega, Jj)
    bi = torch.einsum("eab,e,ea->eb", Ji, omega, r)
    bj = torch.einsum("eab,e,ea->eb", Jj, omega, r)
    return (torch.cat([Hii.reshape(-1, 49), bi], dim=-1),
            torch.cat([Hjj.reshape(-1, 49), bj], dim=-1))


def _pgo_shard(S_init, ei, ej, S_meas, w_edge, fixed, lam0: float, lm_iters: int,
               cg_iters: int, huber: float, mesh: Mesh):
    """This rank's part of the edge-sharded solve: S_init / fixed
    replicated, the edge arrays this rank's shard. Returns replicated S
    and energy."""
    K = S_init.shape[0]
    dt, dev = S_init.dtype, S_init.device
    ei, ej = ei.long(), ej.long()
    S_meas_inv = lie.sim3_inverse(S_meas.to(dt))
    w_edge = w_edge.to(dt)
    free = (~fixed)[:, None]
    eye = torch.eye(7, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def scatter(a_i, a_j):
        out = torch.zeros((K,) + a_i.shape[1:], dtype=dt, device=dev)
        return out.index_add(0, ei, a_i).index_add(0, ej, a_j)

    def energy(S):
        r = edge_residual(S[ei], S[ej], S_meas_inv)
        return _psum_scalar(mesh, _huber_energy(r, w_edge, huber))

    S = S_init
    lam = torch.as_tensor(lam0, dtype=dt, device=dev)
    E = energy(S_init)
    for _ in range(lm_iters):
        r, Ji, Jj, omega = _edge_system(S, ei, ej, S_meas_inv, w_edge, huber)
        # local scatter-add of block diagonal + gradient, ONE all-reduce
        packed = mesh.psum_(scatter(*_edge_blocks(r, Ji, Jj, omega)))
        diag = packed[:, :49].reshape(K, 7, 7)
        b = torch.where(free, packed[:, 49:], zero)
        damp = _damping(diag, lam)[:, None]                           # [K, 1]
        diag_inv = torch.linalg.inv(diag + damp[..., None] * eye)

        def matvec(x):
            """(JᵀΩJ + λD)x: local edge gather/scatter + one all-reduce."""
            u = omega[:, None] * (torch.einsum("eab,eb->ea", Ji, x[ei])
                                  + torch.einsum("eab,eb->ea", Jj, x[ej]))
            y = mesh.psum_(scatter(torch.einsum("eab,ea->eb", Ji, u),
                                   torch.einsum("eab,ea->eb", Jj, u)))
            return torch.where(free, y + damp * x, zero)

        def precond(x):
            return torch.where(free, torch.einsum("kab,kb->ka", diag_inv, x), zero)

        x = _cg(matvec, precond, b, torch.zeros((K, 7), dtype=dt, device=dev), cg_iters)
        dx = torch.where(free, x, zero)
        S_new = lie.sim3_mul(lie.sim3_exp(dx), S)
        S, lam, E = _lm_update(S, S_new, lam, E, energy(S_new))
    return S, E


def make_distributed_pgo(mesh: Mesh, lm_iters: int = 20, cg_iters: int = 60,
                         huber: float = 0.5):
    """Build the edge-sharded pose-graph optimizer:
      ``run(S_init [K,4,4], ei [E_r], ej [E_r], S_meas [E_r,4,4],
      w_edge [E_r], fixed [K], lam0=1e-4) -> PGOResult``
    with the edge arrays this rank's shard (``shard_edges``) and S_init /
    fixed the same on every rank; the result is replicated."""

    def run(S_init, ei, ej, S_meas, w_edge, fixed, lam0: float = 1e-4):
        S, E = _pgo_shard(S_init, ei, ej, S_meas, w_edge, fixed, lam0,
                          lm_iters, cg_iters, huber, mesh)
        return PGOResult(S=S, energy=E, iterations=lm_iters)

    return run


def shard_edges(ei, ej, S_meas, w_edge, mesh: Mesh, *, device="cuda"):
    """Sort the edge list by owning vertex (→ contiguous KF blocks per
    rank), pad it with w_edge = 0 slots to a multiple of the rank count,
    and return this rank's contiguous slice as tensors on ``device``."""
    n = mesh.size
    ei = np.asarray(ei)
    ej = np.asarray(ej)
    S_meas = np.asarray(S_meas)
    w_edge = np.asarray(w_edge)
    order = np.argsort(ei, kind="stable")
    ei, ej, S_meas, w_edge = ei[order], ej[order], S_meas[order], w_edge[order]
    E = len(ei)
    pad = (-E) % n
    if pad:
        ei = np.concatenate([ei, np.zeros(pad, ei.dtype)])
        ej = np.concatenate([ej, np.zeros(pad, ej.dtype)])
        S_meas = np.concatenate(
            [S_meas, np.tile(np.eye(4, dtype=S_meas.dtype), (pad, 1, 1))])
        w_edge = np.concatenate([w_edge, np.zeros(pad, w_edge.dtype)])
    m = len(ei) // n
    blk = slice(mesh.rank * m, (mesh.rank + 1) * m)
    return tuple(torch.as_tensor(a[blk], device=device) for a in (ei, ej, S_meas, w_edge))


def make_mesh(n: Optional[int] = None) -> Mesh:
    """1-D mesh over the ranks of the process group (``n``, if given, must
    be the world size)."""
    return Mesh((n or torch.distributed.get_world_size(),), (AXIS,))


# ---------------------------------------------------------------------------
# Block-row-partitioned PGO with halo exchange


def partition_pose_graph(K: int, ei, ej, S_meas, w_edge, n_blocks: int):
    """Host-side graph partition: contiguous KF blocks, per-block edge
    lists (owned by the i endpoint), halo tables and encoded endpoint
    indices into [own block | gathered halo buffers]."""
    B = -(-K // n_blocks)
    Kp = B * n_blocks
    ei = np.asarray(ei, np.int64)
    ej = np.asarray(ej, np.int64)
    S_meas = np.asarray(S_meas, np.float32)
    w_edge = np.asarray(w_edge, np.float32)
    live = w_edge > 0
    owner_e = np.minimum(ei // B, n_blocks - 1)

    # rows each owner must EXPORT (referenced as a remote j endpoint)
    need: list = [set() for _ in range(n_blocks)]
    for e in np.flatnonzero(live):
        oj = min(int(ej[e]) // B, n_blocks - 1)
        if oj != owner_e[e]:
            need[oj].add(int(ej[e]))
    halo = [np.sort(np.asarray(sorted(v), np.int64)) for v in need]
    H = max(1, max((len(h) for h in halo), default=1))
    halo_out = np.zeros((n_blocks, H), np.int32)
    halo_mask = np.zeros((n_blocks, H), bool)
    halo_pos = [dict() for _ in range(n_blocks)]
    for d in range(n_blocks):
        for p, g in enumerate(halo[d]):
            halo_out[d, p] = int(g) - d * B
            halo_mask[d, p] = True
            halo_pos[d][int(g)] = p

    counts = [int((live & (owner_e == d)).sum()) for d in range(n_blocks)]
    E_max = max(1, max(counts))
    ei_enc = np.zeros((n_blocks, E_max), np.int32)
    ej_enc = np.zeros((n_blocks, E_max), np.int32)
    Sm = np.tile(np.eye(4, dtype=np.float32), (n_blocks, E_max, 1, 1))
    we = np.zeros((n_blocks, E_max), np.float32)
    fill = [0] * n_blocks
    for e in np.flatnonzero(live):
        d = int(owner_e[e])
        p = fill[d]
        fill[d] += 1
        ei_enc[d, p] = int(ei[e]) - d * B
        oj = min(int(ej[e]) // B, n_blocks - 1)
        if oj == d:
            ej_enc[d, p] = int(ej[e]) - d * B
        else:
            ej_enc[d, p] = B + oj * H + halo_pos[oj][int(ej[e])]
        Sm[d, p] = S_meas[e]
        we[d, p] = w_edge[e]
    return dict(B=B, H=H, Kp=Kp, n=n_blocks, ei=ei_enc, ej=ej_enc,
                S_meas=Sm, w=we, halo_out=halo_out, halo_mask=halo_mask)


def _block_pgo_shard(S_blk, fixed_blk, ei, ej, S_meas, w_edge, halo_out, halo_mask,
                     lam0: float, B: int, H: int, lm_iters: int, cg_iters: int,
                     huber: float, mesh: Mesh):
    """This rank's part of the block solve: its [B] vertex rows, its edges
    (endpoints encoded into [own block | all ranks' halos]) and its halo
    table. Returns (S_blk, replicated energy)."""
    n = mesh.size
    dt, dev = S_blk.dtype, S_blk.device
    free = (~fixed_blk)[:, None]                                      # [B, 1]
    S_meas_inv = lie.sim3_inverse(S_meas.to(dt))
    w_edge = w_edge.to(dt)
    mask_f = halo_mask.to(dt)
    eye = torch.eye(7, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def halo_gather(x_blk):
        """[B, ...] -> [B + n·H, ...] (own rows | all ranks' halos)."""
        shape = (H,) + (1,) * (x_blk.ndim - 1)
        allh = mesh.all_gather(x_blk[halo_out] * mask_f.reshape(shape))   # [n, H, ...]
        return torch.cat([x_blk, allh.reshape((n * H,) + x_blk.shape[1:])])

    def halo_scatter_back(y_comb):
        """Return remote-row contributions to their owners and add."""
        rest = y_comb.shape[1:]
        recv = mesh.all_to_all(y_comb[B:].reshape((n, H) + rest))
        contrib = torch.sum(recv, dim=0) * mask_f.reshape((H,) + (1,) * len(rest))
        return y_comb[:B].index_add(0, halo_out, contrib)

    def scatter(a_i, a_j):
        out = torch.zeros((B + n * H,) + a_i.shape[1:], dtype=dt, device=dev)
        return out.index_add(0, ei, a_i).index_add(0, ej, a_j)

    def energy(S_comb):
        r = edge_residual(S_comb[ei], S_comb[ej], S_meas_inv)
        return _psum_scalar(mesh, _huber_energy(r, w_edge, huber))

    def pdot(a, c):
        return _psum_scalar(mesh, torch.sum(a * c))

    lam = torch.as_tensor(lam0, dtype=dt, device=dev)
    E = energy(halo_gather(S_blk))
    for _ in range(lm_iters):
        r, Ji, Jj, omega = _edge_system(halo_gather(S_blk), ei, ej, S_meas_inv, w_edge,
                                        huber)
        packed = halo_scatter_back(scatter(*_edge_blocks(r, Ji, Jj, omega)))    # [B, 56]
        diag = packed[:, :49].reshape(B, 7, 7)
        b = torch.where(free, packed[:, 49:], zero)
        damp = _damping(diag, lam)[:, None]
        diag_inv = torch.linalg.inv(diag + damp[..., None] * eye)

        def matvec(x_blk):
            x_comb = halo_gather(x_blk)
            u = omega[:, None] * (torch.einsum("eab,eb->ea", Ji, x_comb[ei])
                                  + torch.einsum("eab,eb->ea", Jj, x_comb[ej]))
            y = halo_scatter_back(scatter(torch.einsum("eab,ea->eb", Ji, u),
                                          torch.einsum("eab,ea->eb", Jj, u)))
            return torch.where(free, y + damp * x_blk, zero)

        def precond(x):
            return torch.where(free, torch.einsum("kab,kb->ka", diag_inv, x), zero)

        x = _cg(matvec, precond, b, torch.zeros((B, 7), dtype=dt, device=dev), cg_iters,
                pdot)
        dx = torch.where(free, x, zero)
        S_new = lie.sim3_mul(lie.sim3_exp(dx), S_blk)
        S_blk, lam, E = _lm_update(S_blk, S_new, lam, E, energy(halo_gather(S_new)))
    return S_blk, E


def make_block_pgo(mesh: Mesh, part: dict, lm_iters: int = 20, cg_iters: int = 60,
                   huber: float = 0.5, *, device="cuda"):
    """Build the block-partitioned optimizer for one partition
    (``partition_pose_graph`` with one block per rank):
      ``run(S_init [Kp,4,4], fixed [Kp] bool, lam0=1e-4) -> PGOResult``
    with S_init / fixed the whole graph on every rank (padded to Kp) and
    ``S`` of the result THIS rank's block, rows r·B .. (r+1)·B, on
    ``device``. Repartition and rebuild when the graph outgrows the
    partition's caps."""
    n, B, H = part["n"], part["B"], part["H"]
    if n != mesh.size:
        raise ValueError(f"a partition into {n} blocks on {mesh.size} ranks")
    r = mesh.rank
    mine = {k: torch.as_tensor(part[k][r], device=device)
            for k in ("ei", "ej", "S_meas", "w", "halo_out", "halo_mask")}
    ei, ej, halo_out = (mine[k].long() for k in ("ei", "ej", "halo_out"))
    blk = slice(r * B, (r + 1) * B)

    def run(S_init, fixed, lam0: float = 1e-4):
        S, E = _block_pgo_shard(S_init[blk], fixed[blk], ei, ej, mine["S_meas"], mine["w"],
                                halo_out, mine["halo_mask"], lam0, B, H, lm_iters,
                                cg_iters, huber, mesh)
        return PGOResult(S=S, energy=E, iterations=lm_iters)

    return run
