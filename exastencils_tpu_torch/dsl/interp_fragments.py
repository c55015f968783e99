"""Fragment execution of the L4 executor: the sharded DSL.

Reference: exastencils_tpu/dsl/interpreter.py (mesh placement :120-126,
storage :446-542, `communicate` :1415-1434) over
exastencils_tpu/parallel/dslsharding.py.  The JAX package keeps each
field as one dense global array padded to a multiple of the device mesh
and lets XLA's SPMD partitioner insert the halo collectives.  PyTorch has
no partitioner, so here each rank of a DomainMesh (one process per
fragment, over torch.distributed) holds its window of the true grid plus
`ghost` layers on the sides that have a neighbour (parallel/topology
FieldWindow), and the executor moves halo data itself:

- `communicate f` exchanges f (the reference's MPI route);
- a statement that reads a field at a nonzero offset exchanges it first
  if it was written, on that level and slot, since its last exchange (a
  stale flag per (field, level, slot)); the dense executor never reads a
  stale neighbour, so this keeps the printed lines the dense run's.

Every statement computes on the whole local array.  Owned points are
exact; ghost points may hold values computed from a partial neighbourhood
and are refreshed by the next exchange (a write makes the field stale).
Masks, coordinates and colours use global indices (`_gidx`, the level's
WindowGrid); reductions count each point on its owner and all-reduce, so
every rank reads the same bits and takes the same branch; inter-grid
operators take their rows and columns of the global transfer matrices,
all-gathering the source where a window does not hold what its owned rows
read (a transfer into a replicated level); a lexicographic sweep whose
rank borders are reference-fragment borders runs locally (cross-fragment
reads are frozen at the sweep's start, as in the reference), any other is
run on fields gathered whole, exactly; field IO gathers to rank 0, which
writes the dense run's bytes, and reads scatter from rank 0.  A program
form this executor cannot take raises NotImplementedError naming it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from exastencils_tpu_torch.core.grid import CELL, NODE, window_grid
from exastencils_tpu_torch.dsl import nodes as N
from exastencils_tpu_torch.dsl.interp_base import _iota
from exastencils_tpu_torch.ops.transfer import (
    apply_separable,
    build_prolong_mats,
    build_restrict_mats,
)
from exastencils_tpu_torch.parallel.dslsharding import sharded_dims, split_starts
from exastencils_tpu_torch.parallel.topology import FieldWindow, FragmentWindows

def _walk(node):
    """Every AST node under `node` (dataclass fields, lists, tuples)."""
    yield node
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            yield from _walk_value(getattr(node, f.name))


def _walk_value(v):
    if isinstance(v, (list, tuple)):
        for x in v:
            yield from _walk_value(x)
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        yield from _walk(v)


class L4FragmentMixin:
    """The sharded DSL's part of L4Executable.  `self.frag` is the
    FragmentWindows of a sharded run, None on a dense one."""

    def _setup_fragments(self, mesh) -> None:
        """Windows and window grids of every level over `mesh`."""
        k = self.k
        if not all(g.is_uniform for g in self._base_grids.values()):
            raise NotImplementedError("the sharded DSL on a non-uniform grid "
                                      "(grid_spacingModel != uniform)")
        self.frag = FragmentWindows(mesh, self._halo_width())
        thr = k.tpu_coarse_replicate_threshold
        # first level whose nodes are sharded along d: the splits of every
        # finer level double its borders (parallel/dslsharding.split_starts)
        self._split_base = {}
        for d in range(k.dimensionality):
            for lvl in range(self.lo, self.hi + 1):
                n = self._base_grids[lvl].shape_of(NODE)
                if sharded_dims(mesh.shape, n, thr)[d]:
                    self._split_base[d] = lvl
                    break
        used = {}
        for info in self.fields.values():
            for lvl in info.levels:
                used.setdefault(lvl, set()).add(info.localization)
        for lvl, locs in used.items():
            if len({self._window(lvl, loc).sharded for loc in locs}) > 1:
                raise NotImplementedError(
                    f"the sharded DSL with node and cell fields on level {lvl} sharded "
                    f"along different dims (tpu_coarse_replicate_threshold {thr})")
        self.grids = {
            lvl: window_grid(g, {loc: tuple(self._window(lvl, loc).bounds(d)
                                            for d in range(g.ndim))
                                 for loc in (NODE, CELL)})
            for lvl, g in self._base_grids.items()}

    def _halo_width(self) -> int:
        """Ghost layers of every sharded field: the reach of the widest
        declared stencil plus the largest access offset (one statement
        can apply a stencil to an offset access), at least 1."""
        r_st = 0
        for name, per_level in self.stencils.items():
            for lvl, entry in per_level.items():
                if isinstance(entry, tuple) and entry and entry[0] == "__decl__":
                    for e in entry[1].entries:
                        r_st = max([r_st] + [abs(int(self._eval_const(o))) for o in e.offsets])
                elif isinstance(entry, tuple) and entry and entry[0] == "__sexpr__":
                    try:  # stencil algebra: the radius of the bound product
                        st = self._stencil_at(name, lvl)
                    except (ValueError, KeyError):
                        continue  # field-valued: its reach is checked when applied
                    r_st = max(r_st, getattr(st, "radius", 0))
        for st in self.stencil_templates.values():
            r_st = max([r_st] + [abs(int(o)) for off in st.offsets for o in off])
        r_off = 0
        for node in _walk(self.prog):
            if isinstance(node, N.Access) and node.offset:
                r_off = max([r_off] + [abs(o) for o in node.offset if isinstance(o, int)])
        return max(1, r_st + r_off)

    # ---------------- geometry ----------------
    def _window(self, level: int, loc: str) -> Optional[FieldWindow]:
        """The FieldWindow of (level, localization) on this rank; None on
        a dense run and on a level gathered whole for a sequential sweep."""
        if self.frag is None or level in self._dense_levels:
            return None
        key = (level, loc)
        w = self._windows.get(key)
        if w is not None:
            return w
        mesh = self.frag.mesh
        n = self._base_grids[level].shape_of(loc)
        sharded = sharded_dims(mesh.shape, n, self.k.tpu_coarse_replicate_threshold)
        starts = []
        for d, on in enumerate(sharded):
            if not on:
                starts.append(None)
                continue
            base = self._split_base[d]
            cells = [self._base_grids[lv].cells[d] for lv in range(base, level + 1)]
            st = split_starts(cells, mesh.shape[d])
            runs = [e - s for s, e in zip(st, st[1:] + (n[d],))]
            if min(runs) < self.frag.ghost:
                raise NotImplementedError(
                    f"the sharded DSL with a fragment of {min(runs)} points along dim {d} "
                    f"on level {level}, fewer than its {self.frag.ghost} ghost layers")
            starts.append(st)
        w = self.frag.window(n, sharded, starts)
        self._windows[key] = w
        return w

    def _field_window(self, name: str, level: int) -> Optional[FieldWindow]:
        return self._window(level, self.fields[name].localization)

    def _gidx(self, shape, d: int, level: int, loc: str) -> torch.Tensor:
        """Global index along d of the points of a (level, loc) array."""
        i = _iota(shape, d, self.device)
        w = self._window(level, loc)
        return i if w is None else i + w.bounds(d)[0]

    def _gshape(self, level: int, loc: str):
        """Global extents of a (level, loc) grid."""
        return self._base_grids[level].shape_of(loc)

    def _owned(self, level: int, loc: str) -> Optional[torch.Tensor]:
        """The points this rank counts in a reduction (None: every rank
        reduces its whole array itself: a dense run, or a level held
        whole on every rank)."""
        w = self._window(level, loc)
        if w is None or not w.any_sharded:
            return None
        key = (level, loc)
        m = self._owned_masks.get(key)
        if m is None:
            m = self.frag.owned_mask(w, self.device)
            self._owned_masks[key] = m
        return m

    def _phys_boundary(self, level: int, loc: str, shape) -> Optional[torch.Tensor]:
        """True on the points of the global grid's boundary planes (None
        on a dense run)."""
        if self._window(level, loc) is None:
            return None
        n = self._gshape(level, loc)
        m = None
        for d in range(len(shape)):
            i = self._gidx(shape, d, level, loc)
            mm = (i == 0) | (i == n[d] - 1)
            m = mm if m is None else m | mm
        return m

    # ---------------- halo state ----------------
    def _halo_key(self, name: str, level: int, slot=None):
        info = self.fields[name]
        return (name, level, self._slot_idx(name, level, slot) if info.num_slots > 1 else 0)

    def _mark_written(self, name: str, level: int, slot=None) -> None:
        if self.frag is not None and name in self.fields:
            self._halo_stale.add(self._halo_key(name, level, slot))

    def _offset_read(self, name: str, level: int, slot=None, reach: int = 1) -> None:
        """Before `name@level` is read `reach` points away: refuse a reach
        beyond the ghost layers, exchange the field if it is stale."""
        if self.frag is None:
            return
        w = self._field_window(name, level)
        if w is None or not w.any_sharded:
            return
        if reach > self.frag.ghost:
            raise NotImplementedError(
                f"the sharded DSL reading {name}@{level} {reach} points away, beyond its "
                f"{self.frag.ghost} ghost layers")
        if self._halo_key(name, level, slot) in self._halo_stale:
            self._exchange_field(name, level, slot, "implicit")

    def _exchange_field(self, name: str, level: int, slot, kind: str) -> None:
        key = self._halo_key(name, level, slot)
        w = self._field_window(name, level)
        if w is not None and w.any_sharded:
            arr = self.state[(name, level)]
            if self.fields[name].num_slots > 1:
                new = arr.clone()
                new[key[2]] = self.frag.exchange(arr[key[2]], w, kind=kind)
            else:
                new = self.frag.exchange(arr, w, kind=kind)
            self.state[(name, level)] = new
        self._halo_stale.discard(key)

    def _exec_communicate(self, s: N.Communicate, fr) -> None:
        """`communicate f`: exchange f's ghost layers with the neighbours
        (on a dense run there is nothing to move, as in the reference
        without MPI).  `begin` exchanges, `finish` has nothing left."""
        if self.frag is None or s.op == "finish":
            return
        lvl = self._resolve_level(s.field.level, fr)
        self._exchange_field(s.field.name, lvl, s.field.slot, "communicate")

    # ---------------- whole fields ----------------
    def _whole(self, value: torch.Tensor, level: int, loc: str) -> torch.Tensor:
        """A (level, loc) array gathered whole on every rank (itself on a
        dense run)."""
        w = self._window(level, loc)
        return value if w is None else self.frag.gather(value, w)

    def _own_window(self, full: torch.Tensor, level: int, loc: str) -> torch.Tensor:
        w = self._window(level, loc)
        return full if w is None else FragmentWindows.window_of(full, w)

    @contextlib.contextmanager
    def _gathered_level(self, level: int, names, keep: str):
        """Run a block with the fields `names` of `level` gathered whole
        and the level dense; afterwards `keep` takes its window of the
        result and the others return unchanged."""
        for nm in names:
            if (nm, level) in self._ghost_rules:
                raise NotImplementedError(
                    f"the sharded DSL gathering {nm}@{level}, which has ghost rules")
        saved = {}
        for nm in names:
            w = self._field_window(nm, level)
            lead = 1 if self.fields[nm].num_slots > 1 else 0
            saved[nm] = (self.state[(nm, level)], w, lead)
            self.state[(nm, level)] = self.frag.gather(self.state[(nm, level)], w, lead)
        grid = self.grids[level]
        self.grids[level] = self._base_grids[level]
        self._dense_levels.add(level)
        try:
            yield
        finally:
            self._dense_levels.discard(level)
            self.grids[level] = grid
            for nm, (arr, w, lead) in saved.items():
                if nm == keep:
                    self.state[(nm, level)] = FragmentWindows.window_of(
                        self.state[(nm, level)], w, lead)
                else:
                    self.state[(nm, level)] = arr
        for key in [k for k in self._halo_stale if k[0] == keep and k[1] == level]:
            self._halo_stale.discard(key)  # windows of whole fields hold exact ghosts

    # ---------------- reductions ----------------
    def _value_window(self, exprs, fr, loop) -> Optional[FieldWindow]:
        """The window of a value a builtin reduces: the loop's, else that
        of the first field the expressions access."""
        if self.frag is None:
            return None
        if loop is not None:
            return self._window(loop.level, loop.localization)
        for e in exprs:
            for node in _walk(e):
                if isinstance(node, N.Access) and node.name in self.fields:
                    return self._field_window(node.name, self._resolve_level(node.level, fr))
        return None

    def _global_reduce(self, v, w: Optional[FieldWindow], op: str, neutral):
        """`op` ("sum", "max") over the global points of a value laid out
        by window w: this rank's owned points, all-reduced.  None where
        the value is not a sharded grid array (the caller reduces it as
        the dense executor does)."""
        if w is None or not w.any_sharded or not isinstance(v, torch.Tensor) \
                or tuple(v.shape[:w.ndim]) != w.shape:
            return None
        own = self.frag.owned_mask(w, v.device)
        own = own[(...,) + (None,) * (v.dim() - w.ndim)]
        masked = torch.where(own, v, neutral)
        red = torch.sum(masked) if op == "sum" else torch.amax(masked)
        return self.frag.all_reduce(red, op)

    def _any(self, m: torch.Tensor, loop) -> bool:
        """Any point of a loop mask, over every rank."""
        own = None if loop is None else self._owned(loop.level, loop.localization)
        if own is None:
            return bool(torch.any(m))
        hit = torch.any(m & own).to(torch.int32)
        return bool(self.frag.all_reduce(hit, "max"))

    # ---------------- inter-grid transfers ----------------
    def _intergrid_windows(self, ig, name: str, arr, f_level: int, loop):
        """Restriction or prolongation of `name@f_level` (local window
        `arr`) into the loop's level: the rows of the global transfer
        matrices of this rank's target window, the columns of the source
        window, or of the whole source (all-gathered) where the owned rows
        read beyond the source window.  A level run whole (a gathered
        sweep) has the whole range."""
        src_loc = self.fields[name].localization
        ws = self._window(f_level, src_loc)
        wt = self._window(loop.level, loop.localization)
        key = ("frag", id(ig), f_level, loop.level, src_loc, loop.localization, arr.dtype,
               ws is None, wt is None)
        plan = self._transfer_cache.get(key)
        if plan is None:
            gs = self._gshape(f_level, src_loc)
            gt = self._gshape(loop.level, loop.localization)
            build = build_restrict_mats if loop.level < f_level else build_prolong_mats
            mats = [np.asarray(M) for M in build(ig, gt, gs, gt)]
            gather = False
            for d, M in enumerate(mats):
                s0, s1 = (0, gt[d]) if wt is None else wt.own(d)
                cols = np.nonzero(M[s0:s1].any(axis=0))[0]
                c0, c1 = (0, gs[d]) if ws is None else ws.bounds(d)
                if len(cols) and (cols[0] < c0 or cols[-1] >= c1):
                    gather = True
            local = []
            for d, M in enumerate(mats):
                r0, r1 = (0, gt[d]) if wt is None else wt.bounds(d)
                c0, c1 = (0, gs[d]) if gather or ws is None else ws.bounds(d)
                local.append(torch.as_tensor(M[r0:r1, c0:c1], dtype=arr.dtype,
                                             device=arr.device))
            plan = (gather, local)
            self._transfer_cache[key] = plan
        gather, local = plan
        if gather:
            arr = self.frag.gather(arr, ws)
        return apply_separable(local, arr)

    # ---------------- sequential sweeps ----------------
    def _seq_on_ranks(self, name: str, level: int, fsizes) -> bool:
        """True where every rank border of name@level lies on a reference
        fragment border, so that a lexicographic sweep never crosses a
        rank border inside a fragment and each rank sweeps its window."""
        w = self._field_window(name, level)
        return all(not w.sharded[d] or all(s % f == 0 for s in w.starts[d])
                   for d, f in enumerate(fsizes))

    # ---------------- field IO ----------------
    def whole_field(self, name: str, level: int, slot=None) -> torch.Tensor:
        """The whole global array of `name@level` (active slot unless
        `slot`): the field itself on a dense run; on a sharded one every
        rank of the mesh must call this (an all-gather) and each gets it."""
        arr = self.get_field(name, level, slot)
        return self._whole(arr, level, self.fields[name].localization)

    def _io_write(self, fn) -> None:
        """Run a writer on rank 0 only; every rank of the mesh waits for it."""
        if self.mesh is None:
            fn()
            return
        if self.mesh.rank == 0:
            fn()
        dist.barrier(group=self.mesh.group)

    def _io_read(self, name: str, level: int, fn) -> None:
        """Store `fn(whole field) -> whole field` (a reader) into
        name@level: rank 0 reads, every rank keeps its window."""
        like = self.whole_field(name, level)
        if self.frag is None:
            self.set_field(name, level, fn(like))
            return
        full = fn(like) if self.mesh.rank == 0 else torch.zeros_like(like)
        full = self.frag.broadcast(torch.as_tensor(full, dtype=like.dtype,
                                                   device=like.device).reshape(like.shape))
        self.set_field(name, level, self._own_window(full, level,
                                                     self.fields[name].localization))
        self._halo_stale.discard(self._halo_key(name, level))

    # ---------------- random initialisation ----------------
    def _loop_draw(self, loop, draw, masked: bool = False):
        """Random values over a loop's points, drawn in the order of the
        global grid: every rank draws the whole grid from the same stream
        and keeps its window.  `draw(shape)`, or `draw(shape, mask)` with
        the loop's mask (gathered whole) when `masked`."""
        w = self._window(loop.level, loop.localization)
        shape = tuple(loop.shape)
        if w is None:
            return draw(shape, loop.mask) if masked else draw(shape)
        gshape = self._gshape(loop.level, loop.localization)
        if not masked:
            full = draw(gshape)
        else:
            mask = None if loop.mask is None else self.frag.gather(
                torch.broadcast_to(loop.mask, shape).to(torch.uint8), w).bool()
            full = draw(gshape, mask)
        return self._own_window(full, loop.level, loop.localization)
