"""Rank-mesh placement for DSL (ExaSlang) execution on explicit fragments.

Reference: exastencils_tpu/parallel/dslsharding.py.  The JAX package keeps
dense global arrays padded to a multiple of the device mesh and lets
XLA's SPMD partitioner insert the collectives.  PyTorch has no such
partitioner, so the port runs one rank per fragment over
torch.distributed (parallel/mesh.DomainMesh) and keeps, on each rank, its
window of the true grid plus ghost layers (parallel/topology.FragmentWindows);
the L4 executor (dsl/interpreter.py) exchanges halos at `communicate` and
before any offset read of a field written since its last exchange.

The placement rules are the JAX package's, copied (the port imports
nothing of it):
- the mesh shape is the reference's decomposition (blocks x fragments
  per block, or `tpu_mesh_shape`) fitted to the rank count
  (`decomposition_from_knowledge`, `fit_to_devices`);
- `build_dsl_mesh` returns None on one rank or a decomposition of 1,
  and the executor then runs dense;
- spatial dim d of a field instance is sharded iff its per-rank extent
  stays at or above `tpu_coarse_replicate_threshold`
  (`sharded_dims`, the JAX `field_spec`); a replicated dim is held whole
  on every rank.  Slot (lead) and matrix (trail) dims are never sharded.

`split_starts` is the port's own: where the JAX package pads node grids
(2^l + 1 points) to a multiple of the mesh, the port splits the cells of
a level into contiguous, possibly unequal runs whose borders double from
one level to the next finer one, so that a coarse fragment's nodes are
the even nodes of the fine fragment below it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch.distributed as dist

from exastencils_tpu_torch.parallel.mesh import DomainMesh


def decomposition_from_knowledge(k, ndim: int) -> List[int]:
    """Desired shards per spatial dim: the reference's blocks x frags
    (domain/ir/IR_InitGeneratedDomain.scala:40-48), overridable by
    tpu_mesh_shape."""
    if k.tpu_mesh_shape:
        want = list(k.tpu_mesh_shape) + [1] * (ndim - len(k.tpu_mesh_shape))
        return want[:ndim]
    return [k.frags_total(d) for d in range(ndim)]


def fit_to_devices(want: List[int], n_devices: int) -> List[int]:
    """Fit a desired decomposition to the device count: among the
    factorizations of the largest feasible device count whose per-axis
    shard counts do not exceed the desired decomposition, pick the one
    closest to the desired aspect ratio.  (The naive decrement-largest
    approach left devices idle: want [4,4] on 8 devices gave [2,3]=6
    used; this gives [2,4]=8.)"""
    nd = len(want)
    cap = [max(1, int(w)) for w in want]

    def factorizations(n, dims):
        if dims == 1:
            yield (n,)
            return
        for f in range(1, n + 1):
            if n % f == 0:
                for rest in factorizations(n // f, dims - 1):
                    yield (f,) + rest

    for n in range(min(n_devices, math.prod(cap)), 0, -1):
        cands = [
            s for s in factorizations(n, nd)
            if all(s[d] <= cap[d] for d in range(nd))
        ]
        if cands:
            return list(min(
                cands,
                key=lambda s: (
                    sum(abs(math.log(s[d] / cap[d])) for d in range(nd)),
                    max(s),  # tie-break toward balanced (square) meshes
                ),
            ))
    return [1] * nd


def world_size(group=None) -> int:
    """Ranks of the initialised process group (or `group`); 1 without one."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def build_dsl_mesh(k, ndim: int, world: Optional[int] = None,
                   group=None) -> Optional[DomainMesh]:
    """This rank's mesh over the spatial axes, named by
    `tpu_mesh_axis_names`; None when the world (default: the initialised
    process group, or `group`, else one rank) has one rank or the
    decomposition is 1.  A group whose size the fitted mesh does not use
    whole raises: every rank holds a fragment (the JAX mesh leaves
    devices idle instead; idle ranks would run the program for nothing)."""
    world = world_size(group) if world is None else int(world)
    want = decomposition_from_knowledge(k, ndim)
    if math.prod(want) <= 1 or world <= 1:
        return None
    shape = fit_to_devices(want, world)
    n = math.prod(shape)
    if n <= 1:
        return None
    if n != world:
        raise ValueError(f"the decomposition {want} fits a mesh {shape} of {n} ranks, "
                         f"the process group has {world}: start {n} ranks")
    names = tuple(k.tpu_mesh_axis_names[:ndim])
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    return DomainMesh(tuple(shape), names, rank, group)


def sharded_dims(mesh_shape: Sequence[int], grid_shape: Sequence[int],
                 threshold: int) -> Tuple[bool, ...]:
    """Per spatial dim of one field instance: sharded over its mesh axis
    iff that axis has more than one rank and the per-rank extent stays
    >= threshold (the JAX package's `field_spec`, coarse-level
    replication switch)."""
    return tuple(
        d < len(mesh_shape) and mesh_shape[d] > 1
        and n // mesh_shape[d] >= max(1, threshold)
        for d, n in enumerate(grid_shape))


def split_starts(cells: Sequence[int], p: int) -> Tuple[int, ...]:
    """First cell of each of `p` ranks along one dim at the last of the
    levels whose cell counts are `cells` (coarsest first): on the
    coarsest the cells split as evenly as floors allow, and each finer
    level doubles the borders (cells[i] = 2 cells[i-1])."""
    c0 = cells[0]
    if c0 < p:
        raise ValueError(f"{c0} cells cannot be split over {p} ranks")
    starts = [(r * c0) // p for r in range(p)]
    for prev, cur in zip(cells, cells[1:]):
        if cur != 2 * prev:
            raise ValueError(f"levels of {prev} and {cur} cells do not double")
        starts = [2 * s for s in starts]
    return tuple(starts)
