"""Rank mesh + multi-process runtime setup on ``torch.distributed``.

Port of ``ldso_tpu/distributed/mesh.py``. The JAX package builds one
``shard_map`` program over a device mesh; the port runs the same
algorithms SPMD, one process per rank, each holding its own shard. Rank
``r`` of ``n`` holds the block that device ``r`` of JAX's 1-D mesh holds,
and a (dcn, ici) mesh lays the ranks out as JAX reshapes its device list:
rows are host groups, columns the ranks of one host, ``rank = row · cols +
col``. A sum over both axes runs in two steps, within a host (ici) first,
then across hosts (dcn).

Backends: ``nccl`` when each rank has a card of its own, ``gloo`` on the
CPU and when several ranks share one card (NCCL refuses two ranks on one
device; gloo stages CUDA tensors through the host). A rank launched by
``torchrun`` calls ``init_distributed(backend)``; ``spawn_ranks`` starts
ranks on this host (``spawn``, since ``fork`` breaks CUDA in the
children) with the environment ``torchrun`` would give them.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing.connection
import os
import socket
import time
import traceback
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DCN_AXIS = "dcn"   # across hosts
ICI_AXIS = "ici"   # within a host
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE")


def init_distributed(backend: str, timeout_s: float = 300.0) -> bool:
    """Join the process group described by torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_WORLD_SIZE); a no-op
    returning False when MASTER_ADDR is not set (one process needs no
    group). With ``nccl`` the rank's card is ``cuda:LOCAL_RANK``. A rank
    that is lost makes the others raise after ``timeout_s`` instead of
    hanging."""
    env = os.environ
    if "MASTER_ADDR" not in env:
        return False
    missing = [k for k in ENV_KEYS if k not in env]
    if missing:
        raise ValueError(f"MASTER_ADDR is set but not {missing}")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        world_size=int(env["WORLD_SIZE"]), rank=int(env["RANK"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


class Mesh:
    """A grid of ``shape`` over all ranks of the default process group,
    with one subgroup per row and per column on a 2-D grid. Every rank
    must build the same meshes in the same order (``new_group`` is a
    collective)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        if len(self.shape) != len(self.axis_names) or len(self.shape) not in (1, 2):
            raise ValueError(f"a mesh has 1 or 2 named axes, got {shape} {axis_names}")
        if math.prod(self.shape) != self.size:
            raise ValueError(f"mesh {self.shape} does not cover the {self.size} ranks")
        self.group = dist.group.WORLD
        if len(self.shape) == 1:
            self.axis_groups = {self.axis_names[0]: self.group}
            return
        rows, cols = self.shape
        row_groups = [dist.new_group([r * cols + c for c in range(cols)])
                      for r in range(rows)]
        col_groups = [dist.new_group([r * cols + c for r in range(rows)])
                      for c in range(cols)]
        # axis 1 (within a row) first: the order of a two-step sum
        self.axis_groups = {self.axis_names[1]: row_groups[self.rank // cols],
                            self.axis_names[0]: col_groups[self.rank % cols]}

    def psum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over every axis of the mesh (on a 2-D mesh
        within a row, then within a column) and return it."""
        for g in self.axis_groups.values():
            dist.all_reduce(t, group=g)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[...] on every rank -> [n, ...] in rank order."""
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return torch.stack(out)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """[n, ...]: row ``d`` goes to rank ``d``; row ``j`` of the result
        came from rank ``j``."""
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        return out


def make_mesh_2d(n_hosts: Optional[int] = None) -> Mesh:
    """(dcn, ici) mesh over all ranks: rows = host groups, columns = ranks
    within a host. ``n_hosts`` defaults to WORLD_SIZE // LOCAL_WORLD_SIZE."""
    n = dist.get_world_size()
    if n_hosts is None:
        n_hosts = max(n // int(os.environ.get("LOCAL_WORLD_SIZE", n)), 1)
    if n % n_hosts != 0:
        raise ValueError(f"{n} ranks not divisible by {n_hosts} hosts")
    return Mesh((n_hosts, n // n_hosts), (DCN_AXIS, ICI_AXIS))


def point_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the landmark/residual banks shard over: every axis
    of the mesh (1-D, or dcn×ici combined)."""
    return tuple(mesh.axis_names)


# ---------------------------------------------------------------------------
# Ranks on this host


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, env: dict, backend: str, timeout_s: float, out_dir: str,
               fn, args) -> None:
    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank % int(env["LOCAL_WORLD_SIZE"])))
    torch.set_num_threads(1)
    try:
        if not init_distributed(backend, timeout_s):
            raise RuntimeError("init_distributed did not pick up the environment")
        fn(*args)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"err_{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(os.path.join(out_dir, f"ok_{rank}"), "w") as f:
        f.write(f"RANK_OK {rank}")


def spawn_ranks(fn, world_size: int, args: tuple = (), *, backend: str, out_dir: str,
                timeout_s: float = 300.0, ranks_per_host: Optional[int] = None) -> None:
    """Run ``fn(*args)`` in ``world_size`` fresh processes on this host,
    each a rank of one process group on ``backend`` (torchrun's
    environment, MASTER_ADDR localhost; LOCAL_WORLD_SIZE
    ``ranks_per_host``, default all). ``fn`` is importable by name. Each
    rank writes ``out_dir/ok_<rank>`` when it is done. Raises unless every
    rank exits 0 and wrote it within ``timeout_s``; the first failure
    kills the other ranks."""
    for r in range(world_size):        # a sentinel of an earlier run proves nothing
        for name in (f"ok_{r}", f"err_{r}"):
            if os.path.exists(os.path.join(out_dir, name)):
                os.remove(os.path.join(out_dir, name))
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world_size),
               LOCAL_WORLD_SIZE=str(ranks_per_host or world_size))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, env, backend, timeout_s, out_dir, fn, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            multiprocessing.connection.wait([p.sentinel for p in procs if p.is_alive()],
                                            timeout=0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    bad = []
    for r, p in enumerate(procs):
        ok = os.path.join(out_dir, f"ok_{r}")
        if p.exitcode != 0 or not os.path.exists(ok):
            err = os.path.join(out_dir, f"err_{r}")
            why = "no traceback written"
            if os.path.exists(err):
                with open(err) as f:
                    why = f.read()
            bad.append(f"rank {r}: exit code {p.exitcode}\n{why}")
    if bad:
        raise RuntimeError(f"{len(bad)} of {world_size} ranks failed:\n" + "\n".join(bad))
