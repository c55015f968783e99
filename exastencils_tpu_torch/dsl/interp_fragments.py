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
The ghost layers cover the widest stencil, counted from the declared
offsets where a stencil expression has field-valued operands (their
products shift coefficients across rank borders, so the fields those
coefficients read are exchanged first), plus the largest access offset.
One placement serves every localization of a level: a dim is split where
each of the level's field kinds keeps the coarse-replication threshold
per rank and each rank at least the ghost layers, else the level holds
it whole.  Masks, coordinates, stretched-grid positions and cell widths
use global indices (`_gidx`, the level's WindowGrid); reductions count
each point on its owner and all-reduce, so every rank reads the same
bits and takes the same branch; inter-grid operators take their rows and
columns of the global transfer matrices, all-gathering the source where a
window does not hold what its owned rows read (a transfer into a
replicated level); `solve locally` on offset unknowns also solves the
blocks anchored in the ghost layers that write owned points, from
exchanged reads (`_block_zone`); a lexicographic sweep whose rank borders
are reference-fragment borders runs locally (cross-fragment reads are
frozen at the sweep's start, as in the reference), any other is run on
fields gathered whole, with their ghost-rule planes, exactly; field IO
gathers to rank 0, which writes the dense run's bytes, and reads scatter
from rank 0.  Staggered programs run dense (dsl/interpreter).  A read
beyond the ghost layers, which no known program form makes, raises
NotImplementedError naming it.
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
from exastencils_tpu_torch.dsl.interp_base import Frame, _and, _iota
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


def _children(node):
    """The AST nodes directly under `node`."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            for x in (v if isinstance(v, (list, tuple)) else (v,)):
                if dataclasses.is_dataclass(x) and not isinstance(x, type):
                    yield x


def _int_offset(off):
    """The integer components of an access offset (others count 0)."""
    return tuple(o if isinstance(o, int) else 0 for o in off or ())


class L4FragmentMixin:
    """The sharded DSL's part of L4Executable.  `self.frag` is the
    FragmentWindows of a sharded run, None on a dense one."""

    def _setup_fragments(self, mesh) -> None:
        """Placement, windows and window grids of every level over `mesh`."""
        self.frag = FragmentWindows(mesh, self._halo_width())
        used = {}
        for info in self.fields.values():
            for lvl in info.levels:
                used.setdefault(lvl, set()).add(info.localization)
        self._placement = self._place_levels(mesh, used)
        self.grids = {
            lvl: window_grid(g, {loc: tuple(self._window(lvl, loc).bounds(d)
                                            for d in range(g.ndim))
                                 for loc in (NODE, CELL)})
            for lvl, g in self._base_grids.items()}

    def _place_levels(self, mesh, used) -> dict:
        """level -> (sharded, starts) per dim, one placement for every
        localization of the level.  A dim is split where each of the
        level's localizations (`used`) keeps at least the threshold per
        rank (the JAX package's field_spec) and each rank at least the
        ghost layers (the exchange reaches the next rank only); else the
        level holds it whole.  The splits of the first split level (the
        base) double on every finer one (parallel/dslsharding.split_starts)."""
        thr = self.k.tpu_coarse_replicate_threshold
        base, placement = {}, {}
        for lvl in range(self.lo, self.hi + 1):
            grid = self._base_grids[lvl]
            shapes = [grid.shape_of(loc) for loc in sorted(used.get(lvl, {NODE}))]
            sharded, starts = [], []
            for d in range(grid.ndim):
                st = None
                if all(sharded_dims(mesh.shape, n, thr)[d] for n in shapes):
                    p = mesh.shape[d]
                    cells = [self._base_grids[lv].cells[d]
                             for lv in range(base.get(d, lvl), lvl + 1)]
                    st = split_starts(cells, p) if cells[0] >= p else None
                    if st is not None and min(e - s for n in shapes for s, e in
                                              zip(st, st[1:] + (n[d],))) < self.frag.ghost:
                        st = None
                    if st is not None:
                        base.setdefault(d, lvl)
                sharded.append(st is not None)
                starts.append(st)
            placement[lvl] = (tuple(sharded), tuple(starts))
        return placement

    def _halo_width(self) -> int:
        """Ghost layers of every sharded field, at least 1: the widest
        stencil's radius plus the largest access offset (one statement
        can apply a stencil to an offset access), and no less than what
        an expression reads (_expr_reach: stencils applied in a row,
        inline products) or a block of a `solve locally` anchored in the
        ghosts reads (_block_zone)."""
        r_st = max([0] + [self._stencil_radius(nm) for nm in self.stencils]
                   + [self._stencil_radius(nm) for nm in self.stencil_templates])
        r_off = r_blk = r_expr = 0
        for node in _walk(self.prog):
            if isinstance(node, N.Access) and node.offset:
                r_off = max([r_off] + [abs(o) for o in _int_offset(node.offset)])
            if isinstance(node, N.BinOp):
                r_expr = max(r_expr, self._expr_reach(node))
            if isinstance(node, N.SolveLocally) and any(u.offset for u in node.unknowns):
                # a block anchored one unknown offset into the ghosts reads
                # its equations' offsets from there
                unk = [_int_offset(u.offset) for u in node.unknowns]
                reads = [_int_offset(a.offset) for a in _walk_value(node.equations)
                         if isinstance(a, N.Access)]
                r_blk = max([r_blk] + [abs(f - u) for fo in reads for uo in unk
                                       for f, u in zip(fo or (0,) * len(uo), uo)])
        return max(1, r_st + r_off, r_st + r_blk, r_expr)

    def _stencil_radius(self, name: str) -> int:
        """A same-level stencil's radius over its levels (0 for a
        transfer): a declaration's or stencil field's offsets; a stencil
        expression's bound product, or where its operands are
        field-valued (no field holds values yet) the radius counted from
        their declarations (_sexpr_radius)."""
        if name in self.stencil_templates:
            return max(abs(int(o)) for off in self.stencil_templates[name].offsets for o in off)
        r = 0
        for lvl, entry in self.stencils[name].items():
            if isinstance(entry, tuple) and entry and entry[0] == "__decl__":
                r = max([r] + [abs(int(self._eval_const(o)))
                               for en in entry[1].entries for o in en.offsets])
            elif isinstance(entry, tuple) and entry and entry[0] == "__sexpr__":
                try:
                    r = max(r, getattr(self._stencil_at(name, lvl), "radius", 0))
                except (ValueError, KeyError):
                    r = max(r, self._sexpr_radius(entry[1].expr))
        return r

    def _sexpr_radius(self, e) -> int:
        """The radius of a stencil-valued expression from its operands'
        declarations: a product adds its factors' radii, a sum takes the
        larger, a transfer counts 1 (the default ones)."""
        if isinstance(e, N.Access):
            if e.name in self.stencils and all(
                    not isinstance(en, tuple) for en in self.stencils[e.name].values()):
                return 1
            return self._stencil_radius(e.name) if self._stencil_valued(e) else 0
        if isinstance(e, N.Call) and e.name in ("transpose", "transposed"):
            return self._sexpr_radius(e.args[0])
        if isinstance(e, N.UnOp):
            return self._sexpr_radius(e.operand)
        if isinstance(e, N.BinOp):
            a, b = self._sexpr_radius(e.lhs), self._sexpr_radius(e.rhs)
            return a + b if e.op == "*" else max(a, b)
        return 0

    def _stencil_valued(self, e) -> bool:
        """Whether an expression evaluates to a stencil (a declared one,
        a stencil field, their sums, scalings, products and transposes)
        rather than to values at points (a stencil applied to an
        operand that reads points)."""
        if isinstance(e, N.Access):
            return e.name in self.stencils or (e.name in self.stencil_templates
                                               and e.sten_entry is None)
        if isinstance(e, N.BinOp):
            if e.op == "*":
                return self._stencil_valued(e.rhs) or (
                    self._stencil_valued(e.lhs) and not any(
                        isinstance(a, N.Access) and (a.name in self.fields
                                                     or a.name.startswith("vf_"))
                        for a in _walk(e.rhs)))
            if e.op == "/":
                return self._stencil_valued(e.lhs)
            return e.op in ("+", "-") and (self._stencil_valued(e.lhs)
                                           or self._stencil_valued(e.rhs))
        if isinstance(e, N.UnOp):
            return self._stencil_valued(e.operand)
        return isinstance(e, N.Call) and e.name in ("transpose", "transposed")

    def _expr_reach(self, e) -> int:
        """How far from its point an expression reads fields: an access
        its offset, a stencil applied to an operand its radius plus the
        operand's reach, anything else the farthest of its parts."""
        if isinstance(e, N.BinOp) and e.op == "*" and self._stencil_valued(e.lhs) \
                and not self._stencil_valued(e.rhs):
            return self._sexpr_radius(e.lhs) + self._expr_reach(e.rhs)
        if isinstance(e, N.Access):
            return max([0] + [abs(o) for o in _int_offset(e.offset)])
        return max([0] + [self._expr_reach(c) for c in _children(e)])

    def _fresh_coefficients(self, e, level: int) -> None:
        """Exchange the stale fields that the coefficients of the stencils
        in a stencil expression read (stencil fields: their coefficient
        arrays): the product and the transpose shift coefficients, so
        owned points read them at ghost points."""
        if self.frag is None:
            return
        for node in _walk(e):
            if not (isinstance(node, N.Access) and (node.name in self.stencils
                                                    or node.name in self.stencil_templates)):
                continue
            lvl = level if node.level is None else node.level.resolve(self.lo, self.hi, level)[0]
            if node.name in self.stencil_templates:
                self._offset_read(node.name, lvl)
                continue
            entry = self.stencils[node.name][lvl]
            if isinstance(entry, tuple) and entry and entry[0] == "__sexpr__":
                self._fresh_coefficients(entry[1].expr, lvl)
            elif isinstance(entry, tuple) and entry and entry[0] == "__decl__":
                for a in _walk_value([en.coef for en in entry[1].entries]):
                    if isinstance(a, N.Access) and a.name in self.fields:
                        self._offset_read(a.name, self._resolve_level(a.level, Frame({}, lvl)),
                                          a.slot)

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
        sharded, starts = self._placement[level]
        w = self.frag.window(self._base_grids[level].shape_of(loc), sharded, starts)
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

    # ---------------- local solves ----------------
    def _block_zone(self, s: N.SolveLocally, unknowns, fr, loop) -> Optional[torch.Tensor]:
        """The anchors of a `solve locally` on offset unknowns whose block
        writes an owned point: the owned box shifted back by each
        unknown's offset, ghost anchors included (None on a dense run, on
        a level held whole, and without offset unknowns, where each block
        writes its own anchor).  Every field the equations read is
        exchanged first, so these blocks solve the dense run's systems
        (_halo_width counts their reach)."""
        if self.frag is None or not any(any(off) for _, _, off in unknowns):
            return None
        w = self._window(loop.level, loop.localization)
        if w is None or not w.any_sharded:
            return None
        for a in _walk_value(s.equations):
            if isinstance(a, N.Access) and a.name in self.fields:
                self._offset_read(a.name, self._resolve_level(a.level, fr), a.slot)
        zone = None
        for _, _, off in unknowns:
            m = None
            for d in range(w.ndim):
                if w.sharded[d]:
                    s0, s1 = w.own(d)
                    i = self._gidx(loop.shape, d, loop.level, loop.localization) + off[d]
                    m = _and(m, (i >= s0) & (i < s1))
            zone = m if zone is None else zone | m
        return zone

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
        result and the others return unchanged.  A field's ghost-rule
        planes are gathered with it: each from the ranks on its side."""
        saved, planes = {}, {}
        for nm in names:
            w = self._field_window(nm, level)
            lead = 1 if self.fields[nm].num_slots > 1 else 0
            saved[nm] = (self.state[(nm, level)], w, lead)
            self.state[(nm, level)] = self.frag.gather(self.state[(nm, level)], w, lead)
            for d, side in self._ghost_rules.get((nm, level), ()):
                key = (self._ghost_key(nm, d, side), level)
                if key in self.state:
                    planes[key] = self.state[key]
                    self.state[key] = self._gather_plane(self.state[key], w, d, side)
        grid = self.grids[level]
        self.grids[level] = self._base_grids[level]
        self._dense_levels.add(level)
        try:
            yield
        finally:
            self._dense_levels.discard(level)
            self.grids[level] = grid
            self.state.update(planes)
            for nm, (arr, w, lead) in saved.items():
                if nm == keep:
                    self.state[(nm, level)] = FragmentWindows.window_of(
                        self.state[(nm, level)], w, lead)
                else:
                    self.state[(nm, level)] = arr
        for key in [k for k in self._halo_stale if k[0] == keep and k[1] == level]:
            self._halo_stale.discard(key)  # windows of whole fields hold exact ghosts

    def _gather_plane(self, plane: torch.Tensor, w: FieldWindow, d: int, side: int):
        """A ghost-rule plane (one point along d) of a field laid out by w,
        whole: the owned boxes of the ranks on the global grid's `side`
        of d (rank coordinate 0 or the last), the only ones whose plane
        lies on the boundary."""
        last = 0 if side < 0 else self.frag.mesh.shape[d] - 1
        pw = dataclasses.replace(w, n=w.n[:d] + (1,) + w.n[d + 1:],
                                 sharded=w.sharded[:d] + (False,) + w.sharded[d + 1:])
        return self.frag.gather(plane, pw, keep=lambda c: c[d] == last)

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
