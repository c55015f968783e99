"""Domain meshes over SPMD ranks, the process group and its transport.

Reference: exastencils_tpu/parallel/mesh.py (`AXIS_NAMES`,
`make_domain_mesh`, `mesh_from_knowledge`).  The JAX package lays a
`jax.sharding.Mesh` over devices and runs one shard_map program; the port
runs one process (rank) per fragment, every rank the same per-fragment
program, over torch.distributed: the reference's own MPI route, one rank
per block.  A `DomainMesh` is the port's mesh: its shape (shard_dims[d]
ranks along array axis d), the JAX axis names, this rank's index in its
process group and the group.  Ranks lie on the mesh in row-major order,
as the JAX package's mesh over a reshaped device list: rank r sits at
`np.unravel_index(r, shape)`.  Mesh coordinates and boundary tests are
host ints, so no rank reads the device to learn where it is.

Transport (`transport`): NCCL where every rank has a card of its own;
gloo on the CPU and where ranks share a card (NCCL refuses two ranks on
one device).  Under gloo, CUDA halo slabs and reductions go through host
buffers (topology.py) while the fields and kernels stay on the card: the
reference's non-CUDA-aware MPI route.

Ranks start through `run_ranks` (torch.multiprocessing.spawn, a
`file://` store in a fresh temporary directory, so no TCP port is fixed)
or, for users, `torchrun` and `init_from_env`.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS_NAMES = ("bx", "by", "bz")


@dataclass(frozen=True)
class DomainMesh:
    """shape[d] ranks along array axis d; `rank` is this process's rank in
    `group` (None: the default group), whose size is prod(shape).  Only
    the exchange and the reductions communicate; building a mesh and a
    backend over it does not, so a mesh of any shape may be made for
    inspection without a process group."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...] = AXIS_NAMES
    rank: int = 0
    group: object = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def coords(self) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def peer(self, coords: Sequence[int]) -> int:
        """The global rank at mesh `coords` (the process group's numbering
        for point-to-point messages)."""
        r = int(np.ravel_multi_index(tuple(coords), self.shape))
        return r if self.group is None else dist.get_global_rank(self.group, r)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def make_domain_mesh(shape: Sequence[int], axis_names: Tuple[str, ...] = None,
                     group=None) -> DomainMesh:
    """The mesh of this rank over the initialised process group (or
    `group`): `shape[d]` ranks along array axis d, their product the
    group's size."""
    shape = tuple(int(s) for s in shape)
    names = tuple(axis_names or AXIS_NAMES[: len(shape)])
    if not dist.is_initialized():
        raise RuntimeError("make_domain_mesh needs an initialised process group "
                           "(run_ranks, or torchrun with init_from_env)")
    size = dist.get_world_size(group)
    if int(np.prod(shape)) != size:
        raise ValueError(f"mesh {shape} needs {int(np.prod(shape))} ranks, the group has {size}")
    return DomainMesh(shape, names, dist.get_rank(group), group)


def mesh_from_knowledge(knowledge, group=None) -> DomainMesh:
    """Mesh shape from Knowledge: `tpu_mesh_shape`, else the rectangular
    block counts domain_rect_numBlocks_* over the spatial dims; axis names
    from `tpu_mesh_axis_names`."""
    if knowledge.tpu_mesh_shape:
        shape = tuple(knowledge.tpu_mesh_shape)
    else:
        shape = tuple(getattr(knowledge, f"domain_rect_numBlocks_{'xyz'[d]}")
                      for d in range(knowledge.dimensionality))
    return make_domain_mesh(shape, tuple(knowledge.tpu_mesh_axis_names[: len(shape)]),
                            group=group)


# ----------------------------------------------------------------------
# starting ranks
# ----------------------------------------------------------------------


def transport(device, world_size: int) -> str:
    """"nccl" where each of `world_size` ranks on `device` gets a card of
    its own, else "gloo" (the CPU, or ranks sharing a card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device of `rank`: the CPU, or card rank % device_count."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _init(rank: int, world_size: int, init_method: str, backend: str, device,
          timeout_s: float) -> torch.device:
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _rank_entry(rank, world_size, tmp, backend, device, timeout_s, fn, args):
    dev = _init(rank, world_size, f"file://{os.path.join(tmp, 'store')}", backend, device,
                timeout_s)
    try:
        out = fn(dev, *args)
        torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, device="cuda", timeout_s: float = 600.0) -> list:
    """Run `fn(device, *args)` on `world_size` spawned ranks and return
    their results, rank by rank.  Each rank sets one intra-op thread,
    takes its device (rank_device), joins a process group over a
    `file://` store in a fresh temporary directory (over transport()),
    and leaves it when `fn` returns.  `fn` and its
    arguments are pickled: `fn` must be a module-level function of a
    module that the ranks can import, its result something torch.save
    writes.  A rank that raises makes this raise (the other ranks are
    terminated); a collective that waits longer than `timeout_s` raises
    in its rank."""
    backend = transport(device, world_size)
    tmp = tempfile.mkdtemp(prefix="exa_ranks_")
    try:
        torch.multiprocessing.spawn(
            _rank_entry, args=(world_size, tmp, backend, str(device), timeout_s, fn, args),
            nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def init_from_env(device="cuda", timeout_s: float = 600.0) -> torch.device:
    """Join the process group that `torchrun` describes (RANK, WORLD_SIZE,
    MASTER_ADDR/PORT in the environment), over transport(); returns this
    rank's device."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return _init(rank, world, "env://", transport(device, world), device, timeout_s)
