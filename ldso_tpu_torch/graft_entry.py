"""Entry points of the port: a one-card step check and a multi-rank
dry run (the counterpart of the JAX package's root ``__graft_entry__.py``).

``entry()`` returns the flagship step, one full Gauss-Newton iteration of
the sliding-window photometric bundle adjustment (residual linearization,
Hessian assembly, Schur elimination, damped solve, state update), with its
input, the ``tiny`` toy window.

``dryrun_multichip(mesh)`` runs inside every rank of a process group
(``distributed/mesh.py``): the point-sharded one-all-reduce BA step at
``preset("default")`` structure on the mesh, then the edge-sharded and
the block-halo Sim(3) pose graphs on a drifted 96-keyframe circle. On N
cards, one rank each:

    torchrun --nproc-per-node N -m ldso_tpu_torch.graft_entry
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from ldso_tpu_torch.ba.residuals import assemble
from ldso_tpu_torch.ba.solve import (_solve_core, apply_step, fix_mask, prior_diag,
                                     scale_vector)
from ldso_tpu_torch.config import preset
from ldso_tpu_torch.core.window import state_delta
from ldso_tpu_torch.distributed import sharded_ba, sharded_pgo
from ldso_tpu_torch.distributed.mesh import Mesh, init_distributed, make_mesh_2d
from ldso_tpu_torch.eval.toys import make_synthetic_window


def _toy(cfg, w=128, h=96, n_frames=3, *, device):
    win, _ = make_synthetic_window(cfg, w=w, h=h, n_frames=n_frames, idepth_noise=0.05,
                                   pose_noise=0.003, device=device)
    return win


def entry(device="cuda"):
    """(ba_gn_step, (win,)): one GN step of the windowed BA at
    ``preset("tiny")`` on the 128×96, 3-frame toy, on ``device``."""
    cfg = preset("tiny")
    win = _toy(cfg, device=device)
    F = cfg.shapes.max_frames
    D = cfg.shapes.state_dim
    prior_d = prior_diag(win.frame_valid, cfg)
    s_vec = torch.as_tensor(scale_vector(F, cfg.scales), device=device)
    fixed = torch.as_tensor(fix_mask(F, 0), device=device)
    zeros = torch.zeros(D, dtype=torch.float32, device=device)
    HM = torch.zeros((D, D), dtype=torch.float32, device=device)

    def ba_gn_step(win):
        sys = assemble(win, huber_th=cfg.ba.huber_th,
                       outlier_sum=cfg.ba.outlier_th_sum_component)
        dx, dd = _solve_core(sys.H, sys.b, sys.H_xd, sys.H_dd, sys.b_d, HM, zeros,
                             state_delta(win), prior_d, s_vec, fixed, zeros, 1e-5,
                             win.p_valid)
        return apply_step(win, dx, dd), sys.energy

    return ba_gn_step, (win,)


def _drifted_circle(K: int = 96, n_edges: int = 128, seed: int = 0):
    """A K-keyframe circle with noisy positions, odometry edges and random
    loop edges across it: (S, ei, ej, S_meas, w, fixed)."""
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(K) / K
    S = np.stack([np.eye(4) for _ in range(K)])
    S[:, 0, 3] = 2.0 * np.sin(th) + 0.02 * rng.standard_normal(K)
    S[:, 2, 3] = 2.0 * (1 - np.cos(th)) + 0.02 * rng.standard_normal(K)
    ei = np.concatenate([np.arange(K - 1), rng.integers(0, K // 2, n_edges - K + 1)])
    ej = np.concatenate([np.arange(1, K), (ei[K - 1:] + K // 2) % K])
    S_meas = np.stack([np.linalg.inv(S[j]) @ S[i] for i, j in zip(ei, ej)]).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return S, ei.astype(np.int32), ej.astype(np.int32), S_meas, np.ones(n_edges, np.float32), fixed


def dryrun_multichip(mesh: Mesh, device="cuda") -> dict:
    """Multi-rank dry run at production structure (preset "default":
    10-slot window, 2048-point bank, 8-pattern residuals; 320×240 frames),
    on ``device``, called by every rank of ``mesh``: (1) the point-sharded
    BA step on ``mesh``, (2) the edge-sharded and (3) the block-halo pose
    graph on a 1-D mesh over the same ranks. Raises on a non-finite
    energy; returns the three energies (the same on every rank)."""
    cfg = preset("default")
    D = cfg.shapes.state_dim
    win = sharded_ba.shard_window(_toy(cfg, w=320, h=240, n_frames=6, device=device), mesh)
    step = sharded_ba.make_distributed_ba_step(mesh, cfg)
    _, E_ba = step(win, np.zeros((D, D), np.float32), np.zeros(D, np.float32))

    S, ei, ej, S_meas, w_e, fixed = _drifted_circle()
    K = len(S)
    mesh1 = sharded_pgo.make_mesh()
    run = sharded_pgo.make_distributed_pgo(mesh1, lm_iters=3, cg_iters=20)
    out = run(torch.as_tensor(S, dtype=torch.float32, device=device),
              *sharded_pgo.shard_edges(ei, ej, S_meas, w_e, mesh1, device=device),
              torch.as_tensor(fixed, device=device))

    # block-row partition with halo exchange: per-CG bytes ∝ the halo, not K
    part = sharded_pgo.partition_pose_graph(K, ei, ej, S_meas, w_e, mesh1.size)
    Kp = part["Kp"]
    S_p = np.concatenate([S, np.tile(np.eye(4), (Kp - K, 1, 1))])
    fixed_p = np.concatenate([fixed, np.ones(Kp - K, bool)])
    run_blk = sharded_pgo.make_block_pgo(mesh1, part, lm_iters=3, cg_iters=20, device=device)
    out2 = run_blk(torch.as_tensor(S_p, dtype=torch.float32, device=device),
                   torch.as_tensor(fixed_p, device=device))

    energies = dict(ba=float(E_ba), pgo=float(out.energy), block_pgo=float(out2.energy))
    bad = [k for k, e in energies.items() if not np.isfinite(e)]
    if bad:
        raise RuntimeError(f"dry run: non-finite energy in {bad}: {energies}")
    return energies


def main(argv=None) -> int:
    """The dry run in every rank of a ``torchrun`` launch; rank 0 prints
    the energies as one JSON line."""
    ap = argparse.ArgumentParser(prog="python -m ldso_tpu_torch.graft_entry")
    ap.add_argument("--backend", default="nccl",
                    help="nccl: a card per rank; gloo: the CPU, or ranks sharing a card")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not init_distributed(args.backend):
        raise SystemExit("no MASTER_ADDR: start the ranks with torchrun")
    try:
        energies = dryrun_multichip(make_mesh_2d(), device=args.device)
        if dist.get_rank() == 0:
            print(json.dumps(dict(world_size=dist.get_world_size(), **energies)), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
