"""Execution backends: dense single-device and fragment-sharded SPMD.

Reference: exastencils_tpu/parallel/backend.py.  A backend provides
per-level handles with one interface (shape, exchange, bc application,
colour masks, ownership-aware reductions, inter-grid transfers, field
initialisation), so the model and solver code is written once:

  * DenseBackend (:53-137): global dense node tensors on one device,
    exchange the identity.  `wrap` stages on CUDA, as the reference's
    jax.jit does: the wrapped function is captured as CUDA graphs per
    binding of its argument tensors and replayed (runtime/staging
    `Staged`), its donated outputs written back into the caller's
    tensors; on the CPU `wrap` returns the function itself.
  * ShardedBackend (:145-476): one fragment per rank (parallel/mesh.py),
    ghost layers exchanged with the neighbours (parallel/topology.py);
    the reference runs the whole solver step in one shard_map, the port
    runs it on every rank, eagerly (`wrap` returns the function: gloo's
    host-side messages cannot be captured in a CUDA graph).  Levels too
    small for the shard grid are replicated: every rank holds and solves
    the whole level (DenseLevelHandle), the crossover gathered and
    scattered with one all-reduce.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from exastencils_tpu_torch.core.field import DirichletBC, Field, NeumannBC, NoBC
from exastencils_tpu_torch.core.grid import NODE, LevelGrid
from exastencils_tpu_torch.core.stencil import IntergridStencil
from exastencils_tpu_torch.ops.boundary import make_bc_applier
from exastencils_tpu_torch.ops.reductions import dot as _dot, norm_l2 as _norm_l2, norm_max as _norm_max
from exastencils_tpu_torch.ops.smoothers import color_mask
from exastencils_tpu_torch.ops.stencil_apply import prolong as dense_prolong, restrict as dense_restrict
from exastencils_tpu_torch.ops.transfer import (
    apply_separable,
    build_prolong_mats,
    build_restrict_mats,
    prolongation_matrix_1d,
    restriction_matrix_1d,
    separable_kernels,
)
from exastencils_tpu_torch.parallel.topology import ShardTopology
from exastencils_tpu_torch.runtime.staging import Staged


def _on(mats, dtype, device):
    """Transfer matrices on the device, once."""
    return [torch.as_tensor(m, dtype=dtype, device=device) for m in mats]


@dataclass
class DenseLevelHandle:
    grid: LevelGrid
    shape: Tuple[int, ...]

    @property
    def device(self) -> torch.device:
        return self.grid.device

    @property
    def work_shape(self):
        """Shape solver code sees (== global shape on the dense path)."""
        return self.shape

    def exchange(self, x):
        return x

    def bc_applier(self, field: Field, level: int) -> Callable:
        return make_bc_applier(field, self.grid, level)

    def color_masks(self, num_colors: int = 2, color_fn=None):
        """One mask per colour, each built on first use and kept."""
        cache = {}

        def mask(c):
            if c not in cache:
                cache[c] = color_mask(self.shape, c, self.device, num_colors, color_fn)
            return cache[c]

        return [(lambda c=c: mask(c)) for c in range(num_colors)]

    def coords(self):
        return self.grid.coord_mesh(NODE)

    def dot(self, a, b):
        return _dot(a, b)

    def norm_l2(self, a):
        return _norm_l2(a)

    def norm_max(self, a):
        return _norm_max(a)

    def zeros(self, dtype):
        return torch.zeros(self.shape, dtype=dtype, device=self.device)

    def init_field_local(self, fn, dtype):
        if fn is None:
            return self.zeros(dtype)
        return fn(*self.coords()) + self.zeros(dtype)


class DenseBackend:
    """Single-device backend over global dense node tensors."""

    is_sharded = False

    def __init__(self, grids: Dict[int, LevelGrid]):
        self.grids = grids
        self.handles = {
            lvl: DenseLevelHandle(g, g.shape_of(NODE)) for lvl, g in grids.items()
        }

    def handle(self, level: int) -> DenseLevelHandle:
        return self.handles[level]

    def transfer_fns(self, fine_level: int, restrict_op: IntergridStencil,
                     prolong_op: IntergridStencil):
        fine = self.handles[fine_level]
        coarse = self.handles[fine_level - 1]
        dev, dt = fine.device, fine.grid.dtype
        try:
            # per-dim banded-matrix contractions (ops/transfer.py), moved
            # to the device once
            r_mats = _on(build_restrict_mats(restrict_op, coarse.shape, fine.shape, coarse.shape),
                         dt, dev)
            p_mats = _on(build_prolong_mats(prolong_op, fine.shape, coarse.shape, fine.shape),
                         dt, dev)
            return (
                lambda res: apply_separable(r_mats, res),
                lambda sol_c: apply_separable(p_mats, sol_c),
            )
        except ValueError:  # non-separable window -> slicing fallback
            return (
                lambda res: dense_restrict(restrict_op, res, coarse.shape),
                lambda sol_c: dense_prolong(prolong_op, sol_c, fine.shape),
            )

    @property
    def device(self) -> torch.device:
        return next(iter(self.handles.values())).device

    def wrap(self, fn, in_kinds=None, out_kinds=None, donate_argnums=()):
        """`fn` staged on CUDA (output i written back into argument
        donate_argnums[i]); `fn` itself on the CPU."""
        if self.device.type != "cuda":
            return fn
        return Staged(fn, donate=donate_argnums)


# ======================================================================
# sharded (SPMD) backend
# ======================================================================


def _plane(nd: int, d: int, index: int) -> tuple:
    return tuple(index if i == d else slice(None) for i in range(nd))


@dataclass
class ShardedLevelHandle:
    """One level's fragment on this rank: `local_cells` per dim, the
    ghosted `local_shape`; `shape` is the stacked global shape of all
    fragments (the reference's fragment-stacked array)."""

    grid: LevelGrid
    topo: ShardTopology
    local_cells: Tuple[int, ...]

    def __post_init__(self):
        self.local_shape = self.topo.local_shape(self.local_cells)
        self.shape = tuple(p * t for p, t in zip(self.topo.P, self.local_shape))
        self._masks = {}

    @property
    def device(self) -> torch.device:
        return self.grid.device

    @property
    def work_shape(self):
        """Shape solver code sees on a rank (the fragment view)."""
        return self.local_shape

    def exchange(self, x):
        return self.topo.exchange(x, self.local_cells)

    def _boundary_planes(self):
        """(dim, local index) of every physical-boundary plane this
        fragment holds, lo before hi per dim."""
        gs, out = self.topo.ghosts, []
        for d in range(self.topo.ndim):
            if self.topo.is_lo_boundary(d):
                out.append((d, gs[d]))
            if self.topo.is_hi_boundary(d):
                out.append((d, gs[d] + self.local_cells[d]))
        return out

    def bc_applier(self, field: Field, level: int) -> Callable:
        """Dirichlet/Neumann on the physical-boundary sides only (the
        reference's :165-221): the dup plane of a fragment on the domain's
        boundary, the whole plane, ghost rows included; a rank's ghost
        layers outside the domain stay as the exchange leaves them."""
        bc = field.bc_at(level)
        nd = self.topo.ndim
        if isinstance(bc, NoBC) or field.localization != NODE:
            return lambda arr: arr
        planes = self._boundary_planes()

        if isinstance(bc, DirichletBC):
            values = {p: bc.value for p in planes}
            if callable(bc.value):
                coords = self.coords()
                for d, i in planes:
                    plane_shape = tuple(s for j, s in enumerate(self.local_shape) if j != d)
                    vals = bc.value(*(c[_plane(nd, d, min(i, c.shape[d] - 1))]
                                      for c in coords))
                    values[(d, i)] = vals + torch.zeros(plane_shape, dtype=self.grid.dtype,
                                                        device=self.device)

            def apply_dirichlet(arr):
                out = arr.clone(memory_format=torch.contiguous_format)
                for d, i in planes:
                    out[_plane(nd, d, i)] = values[(d, i)]
                return out

            return apply_dirichlet

        if isinstance(bc, NeumannBC):
            order = bc.order
            gs = self.topo.ghosts

            def apply_neumann(arr):
                # the boundary plane from its interior neighbours along
                # the normal, both sides of a dim from the same array
                out = arr.clone(memory_format=torch.contiguous_format)
                for d in range(nd):
                    lo, hi = gs[d], gs[d] + self.local_cells[d]
                    src = out.clone()

                    def at(i):
                        return src[_plane(nd, d, i % src.shape[d])]

                    for i, s in ((lo, 1), (hi, -1)):
                        if (d, i) not in planes:
                            continue
                        if order == 1:
                            out[_plane(nd, d, i)] = at(i + s)
                        else:
                            out[_plane(nd, d, i)] = (4.0 * at(i + s) - at(i + 2 * s)) / 3.0
                return out

            return apply_neumann

        raise TypeError(f"unsupported bc {bc!r}")

    def color_masks(self, num_colors: int = 2, color_fn=None):
        """One mask per colour from the GLOBAL index parity (the
        fragment's offsets added), each built on first use and kept."""
        offs = self.topo.index_offsets(self.local_cells)
        cache = {}

        def mask(c):
            if c not in cache:
                cache[c] = color_mask(self.local_shape, c, self.device, num_colors, color_fn,
                                      index_offset=offs)
            return cache[c]

        return [(lambda c=c: mask(c)) for c in range(num_colors)]

    def coords(self):
        return self.topo.local_coords(self.grid, self.local_cells, self.local_shape)

    # ownership-aware reductions ---------------------------------------
    def _owned(self):
        if "owned" not in self._masks:
            self._masks["owned"] = self.topo.owned_mask(self.local_shape, self.local_cells,
                                                        self.device)
        return self._masks["owned"]

    def dot(self, a, b):
        return self.topo.psum(torch.sum(torch.where(self._owned(), a * b, 0)))

    def norm_l2(self, a):
        return torch.sqrt(self.dot(a, a))

    def norm_max(self, a):
        return self.topo.pmax(torch.max(torch.where(self._owned(), torch.abs(a), 0)))

    def zeros(self, dtype):
        return torch.zeros(self.local_shape, dtype=dtype, device=self.device)

    def init_field_local(self, fn, dtype):
        if fn is None:
            return self.zeros(dtype)
        return fn(*self.coords()) + self.zeros(dtype)


class ShardedBackend:
    """One fragment per rank over a DomainMesh; the solver's steps run on
    every rank (SPMD), eagerly."""

    is_sharded = True

    def __init__(self, grids: Dict[int, LevelGrid], mesh, shard_dims: Tuple[int, ...],
                 ghost: int = 1, replicate_below: int = 0):
        """shard_dims[d] = shards along array axis d (product = mesh size;
        dims with 1 are unsharded).

        Levels whose cells are not divisible by the shard grid, or whose
        extent drops below `replicate_below` cells per sharded dim
        (Knowledge.tpu_coarse_replicate_threshold), are REPLICATED: every
        rank holds and solves the full level (the reference's coarse-grid
        agglomeration).  The finest level is always sharded and must be
        divisible."""
        self.mesh = mesh
        shard_dims = tuple(int(p) for p in shard_dims)
        if tuple(mesh.shape) != shard_dims:
            raise ValueError(
                f"mesh shape {tuple(mesh.shape)} != shard_dims {shard_dims}; "
                "build the mesh with one axis per spatial dim (size 1 allowed)")
        names = tuple(n if p > 1 else None for n, p in zip(mesh.axis_names, shard_dims))
        self.topo = ShardTopology(mesh, shard_dims, names, ghost)
        self.grids = grids
        self.handles = {}
        self.replicated: set = set()
        finest = max(grids)
        for lvl, g in grids.items():
            cells = g.cells
            per_shard = [c // p for c, p in zip(cells, shard_dims) if p > 1]
            divisible = all(c % p == 0 and c // p >= 1 for c, p in zip(cells, shard_dims))
            shardable = divisible and (lvl == finest or not per_shard
                                       or min(per_shard) >= max(1, replicate_below))
            if not shardable:
                if lvl == finest:
                    raise ValueError(f"finest level {lvl}: cells {cells} not divisible by "
                                     f"the {shard_dims} shard grid")
                self.replicated.add(lvl)
                self.handles[lvl] = DenseLevelHandle(g, g.shape_of(NODE))
                continue
            local = tuple(c // p for c, p in zip(cells, shard_dims))
            self.handles[lvl] = ShardedLevelHandle(g, self.topo, local)

    def handle(self, level: int):
        return self.handles[level]

    @property
    def device(self) -> torch.device:
        return next(iter(self.handles.values())).device

    # replicated-coarse support: the full level on every rank at the
    # sharded -> replicated crossover
    def gather_global(self, level: int, x):
        """Fragment view -> the full global node array on EVERY rank: the
        owned nodes embedded in zeros, then one all-reduce (each node has
        one owner, so every rank gets the same bits)."""
        h = self.handles[level]
        topo = self.topo
        nd = topo.ndim
        lay = topo.layout(tuple(h.local_cells))
        xo = torch.where(h._owned(), x, 0)
        block = xo[tuple(slice(lay.idx("DLB", d), lay.idx("DRE", d)) for d in range(nd))]
        embedded = torch.zeros(h.grid.shape_of(NODE), dtype=x.dtype, device=x.device)
        starts = [topo.axis_index(d) * h.local_cells[d] for d in range(nd)]
        embedded[tuple(slice(s, s + n) for s, n in zip(starts, block.shape))] = block
        return topo.psum(embedded)

    def scatter_local(self, level: int, x_global):
        """Full global node array -> this fragment's local view (ghosts
        filled from the global data; physical-boundary ghosts zero)."""
        h = self.handles[level]
        topo = self.topo
        gs = topo.ghosts
        padded = torch.zeros(tuple(n + 2 * g for n, g in zip(x_global.shape, gs)),
                             dtype=x_global.dtype, device=x_global.device)
        padded[tuple(slice(g, g + n) for g, n in zip(gs, x_global.shape))] = x_global
        starts = [topo.axis_index(d) * h.local_cells[d] for d in range(topo.ndim)]
        return padded[tuple(slice(s, s + n) for s, n in zip(starts, h.local_shape))].contiguous()

    def transfer_fns(self, fine_level: int, restrict_op: IntergridStencil,
                     prolong_op: IntergridStencil):
        """Fragment-local transfers as banded contractions over the ghosted
        local arrays: coarse node j reads fine local 2j - g + lo + k (the
        fine ghosts hold the neighbours' values after the preceding
        exchange); ghost output rows are zero.

        Replicated coarse levels: below the crossover both levels are
        global dense arrays (the dense backend's maths); AT the crossover
        the fine fragments are gathered once, transferred densely, and
        scattered back."""
        fh = self.handles[fine_level]
        ch = self.handles[fine_level - 1]
        dev, dt = fh.device, fh.grid.dtype
        fine_rep = fine_level in self.replicated
        coarse_rep = (fine_level - 1) in self.replicated
        if fine_rep and coarse_rep:
            r_mats = _on(build_restrict_mats(restrict_op, ch.shape, fh.shape, ch.shape), dt, dev)
            p_mats = _on(build_prolong_mats(prolong_op, fh.shape, ch.shape, fh.shape), dt, dev)
            return (lambda res: apply_separable(r_mats, res),
                    lambda sol_c: apply_separable(p_mats, sol_c))
        if coarse_rep:
            fS = fh.grid.shape_of(NODE)
            r_mats = _on(build_restrict_mats(restrict_op, ch.shape, fS, ch.shape), dt, dev)
            p_mats = _on(build_prolong_mats(prolong_op, fS, ch.shape, fS), dt, dev)
            return (lambda res: apply_separable(r_mats, self.gather_global(fine_level, res)),
                    lambda sol_c: self.scatter_local(fine_level, apply_separable(p_mats, sol_c)))
        if fine_rep:
            # shardability is monotone toward coarse levels
            raise AssertionError(
                "replicated fine level above sharded coarse level: the replication "
                "threshold must be monotone toward coarse levels")
        gs = self.topo.ghosts
        r_kern, p_kern = separable_kernels(restrict_op), separable_kernels(prolong_op)
        r_mats = _on([restriction_matrix_1d(
            r_kern[d], restrict_op.lo[d], ch.local_cells[d] + 1, fh.local_shape[d],
            ch.local_shape[d], ghost_in=gs[d], ghost_out=gs[d]) for d in range(self.topo.ndim)],
            dt, dev)
        p_mats = _on([prolongation_matrix_1d(
            p_kern[d], prolong_op.lo[d], fh.local_cells[d] + 1, ch.local_shape[d],
            fh.local_shape[d], ghost_in=gs[d], ghost_out=gs[d]) for d in range(self.topo.ndim)],
            dt, dev)
        return (lambda res: apply_separable(r_mats, res),
                lambda sol_c: apply_separable(p_mats, sol_c))

    def wrap(self, fn, in_kinds=None, out_kinds=None, donate_argnums=()):
        """The function itself: every rank runs it on its fragment,
        eagerly."""
        return fn

    def init_field(self, level: int, fn, dtype):
        """This rank's fragment of fn over the level's nodes (zeros for
        fn None)."""
        return self.handles[level].init_field_local(fn, dtype)
