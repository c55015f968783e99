"""Fragment topology: local index algebra, halo exchange and reductions
over SPMD ranks.

Reference: exastencils_tpu/parallel/topology.py (`ShardTopology` :35-299,
`dense_to_fragments` / `fragments_to_dense` :301-339, copied).  Each rank
holds one fragment in the reference's memory layout [ghost g | dup 1 |
inner | dup 1 | ghost g] per sharded dim (field/ir/IR_FieldLayout.scala:
51-73; an unsharded dim has no ghosts).  The JAX package's per-axis
`lax.ppermute` shifts become one `dist.batch_isend_irecv` per axis, in
its axis order, so that edges and corners arrive (comm_onlyAxisNeighbors
semantics); a rank with no neighbour on a side writes zeros there, as
ppermute does (the reference's physical-boundary ghosts).  `psum` and
`pmax` are `dist.all_reduce` over the mesh's group: every rank gets the
same bits, so every rank takes the same branch on a reduced value.  The
mesh coordinates, and so the boundary tests, are host ints.

Ownership (reductions, `loop over` bounds): dup-left is owned only by
fragments on the physical lower boundary; dup-right is always owned
(IR_LoopOverPointsInOneFragment.scala:78-101).

Transport: under gloo, CUDA slabs and reduced values go through pinned
host buffers (kept per message, reused); under NCCL and on the CPU the
tensors themselves are sent.  `stats` counts the exchanges and the bytes
they send; with `stats.timed` each exchange also synchronises the card
before and after itself and adds its host seconds (the instrumentation of
chip_smoke.py's exchange share).

The sharded DSL (dsl/interp_fragments) lays its fields out otherwise:
`FieldWindow` is one rank's window of a field instance of any
localization (possibly unequal runs of a level's cells, unsharded dims
held whole, windows clipped at the physical boundary, lead and trail
dims), and `FragmentWindows` exchanges, gathers and reduces such arrays
over the same transport.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from exastencils_tpu_torch.core.layout import FieldLayout, LayoutPerDim


@dataclass
class ExchangeStats:
    calls: int = 0
    bytes_sent: int = 0
    seconds: float = 0.0
    timed: bool = False


def _sl(nd: int, d: int, lo: int, hi: int) -> tuple:
    """Slice [lo, hi) along d, everything elsewhere."""
    return tuple(slice(lo, hi) if i == d else slice(None) for i in range(nd))


class _Pending:
    """Point-to-point messages in flight (exchange_start); `result()`
    waits for them once and returns the received slabs by key."""

    def __init__(self, works, recvs, device):
        self._works, self._recvs, self._device, self._out = works, recvs, device, None

    def result(self) -> Dict[tuple, torch.Tensor]:
        if self._out is None:
            for w in self._works:
                w.wait()
            self._out = {key: (buf.to(self._device) if buf.device != self._device else buf)
                         for key, buf in self._recvs.items()}
        return self._out


@dataclass(frozen=True)
class ShardTopology:
    """Static description of the fragment decomposition of one level set.

    mesh   : this rank's DomainMesh (None: host-side index algebra only)
    P[d]   : number of shards along array axis d (1 = unsharded)
    names  : mesh axis name per dim (None where unsharded)
    ghost  : halo width g
    """

    mesh: object
    P: Tuple[int, ...]
    names: Tuple[Optional[str], ...]
    ghost: int = 1
    stats: ExchangeStats = field(default_factory=ExchangeStats, compare=False, repr=False)
    _buffers: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def ndim(self) -> int:
        return len(self.P)

    @property
    def ghosts(self) -> Tuple[int, ...]:
        """Per-dim halo width: `ghost` along sharded dims, 0 along
        unsharded ones (their array edge is the physical boundary)."""
        return tuple(self.ghost if p > 1 else 0 for p in self.P)

    # ---------------- local layout (node-centered) ----------------
    def layout(self, local_cells: Tuple[int, ...]) -> FieldLayout:
        pds = tuple(LayoutPerDim(0, g, 1, n - 1, 1, g, 0)
                    for n, g in zip(local_cells, self.ghosts))
        return FieldLayout("fragment", "Node", pds, communicates_duplicated=True,
                           communicates_ghosts=self.ghost > 0)

    def local_shape(self, local_cells: Tuple[int, ...]) -> Tuple[int, ...]:
        """[ghost | dup | inner | dup | ghost] per dim."""
        return self.layout(tuple(local_cells)).shape

    def node_lo(self, d: int) -> int:
        return self.ghosts[d]

    def node_hi(self, d: int, n: int) -> int:
        return self.ghosts[d] + n  # inclusive dup-right / boundary node

    # ---------------- mesh queries (host ints) ----------------
    def axis_index(self, d: int) -> int:
        return 0 if self.P[d] == 1 else self.mesh.coords[d]

    def is_lo_boundary(self, d: int) -> bool:
        return self.axis_index(d) == 0

    def is_hi_boundary(self, d: int) -> bool:
        return self.axis_index(d) == self.P[d] - 1

    # ---------------- point-to-point transport ----------------
    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.mesh.backend == "gloo"

    def _host(self, key, like: torch.Tensor) -> torch.Tensor:
        """The pinned host buffer of message `key`, made on first use."""
        buf = self._buffers.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._buffers[key] = buf
        return buf

    def _post(self, sends, recvs, device) -> _Pending:
        """Start isend of each (key, slab, peer, tag) of `sends` and irecv
        of each (key, like, peer, tag) of `recvs` (one buffer shaped as
        `like`)."""
        ops, bufs = [], {}
        for key, slab, peer, tag in sends:
            if self._staged(slab):
                buf = self._host(("send",) + key, slab)
                buf.copy_(slab)
            else:
                buf = slab.contiguous()
            self.stats.bytes_sent += buf.numel() * buf.element_size()
            ops.append(dist.P2POp(dist.isend, buf, peer, self.mesh.group, tag))
        for key, like, peer, tag in recvs:
            buf = (self._host(("recv",) + key, like) if self._staged(like)
                   else torch.empty(like.shape, dtype=like.dtype, device=like.device))
            bufs[key] = buf
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.mesh.group, tag))
        works = dist.batch_isend_irecv(ops) if ops else []
        return _Pending(works, bufs, device)

    def _axis_messages(self, x, d: int, n: int):
        """Sends and receives of one axis: the owner's [n .. n+g] node
        slab (dup-right included) to the +d neighbour's [0 .. g] (ghost-
        left + dup-left), and the [g+1 .. 2g] interior slab to the -d
        neighbour's ghost-right; tag 2d for the +d direction, 2d+1 for
        -d."""
        g, nd = self.ghost, self.ndim
        c = list(self.mesh.coords)
        sends, recvs = [], []
        hi_slab = x[_sl(nd, d, n, n + g + 1)]
        lo_slab = x[_sl(nd, d, g + 1, 2 * g + 1)]
        if c[d] > 0:
            lo_peer = self.mesh.peer(c[:d] + [c[d] - 1] + c[d + 1:])
            sends.append(((d, -1), lo_slab, lo_peer, 2 * d + 1))
            recvs.append(((d, +1), hi_slab, lo_peer, 2 * d))
        if c[d] < self.P[d] - 1:
            hi_peer = self.mesh.peer(c[:d] + [c[d] + 1] + c[d + 1:])
            sends.append(((d, +1), hi_slab, hi_peer, 2 * d))
            recvs.append(((d, -1), lo_slab, hi_peer, 2 * d + 1))
        return sends, recvs

    def _write(self, out, d: int, slabs) -> None:
        """The received slabs of axis d into out's ghost+dup layers; zeros
        where no neighbour sent (the physical-boundary ghosts), and the
        dup-left plane kept on the physical lo boundary (it is the
        boundary node there)."""
        g, nd, T = self.ghost, self.ndim, out.shape[d]
        if (d, +1) in slabs:
            out[_sl(nd, d, 0, g + 1)] = slabs[(d, +1)]
        else:
            out[_sl(nd, d, 0, g)] = 0
        if (d, -1) in slabs:
            out[_sl(nd, d, T - g, T)] = slabs[(d, -1)]
        else:
            out[_sl(nd, d, T - g, T)] = 0

    def _tic(self, x):
        self.stats.calls += 1
        if self.stats.timed:
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return time.perf_counter()
        return None

    def _toc(self, x, t0):
        if t0 is not None:
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            self.stats.seconds += time.perf_counter() - t0

    # ---------------- halo exchange ----------------
    def exchange(self, x: torch.Tensor, local_cells: Tuple[int, ...]) -> torch.Tensor:
        """A copy of x with its ghost+dup layers filled from the neighbours
        along every sharded dim, axis after axis (so corners resolve
        after later dims); physical-boundary ghosts zero, the physical
        boundary's dup plane kept."""
        t0 = self._tic(x)
        out = x.clone()
        for d in range(self.ndim):
            if self.P[d] == 1:
                continue
            sends, recvs = self._axis_messages(out, d, local_cells[d])
            self._write(out, d, self._post(sends, recvs, x.device).result())
        self._toc(x, t0)
        return out

    # ---------------- split (overlapped) halo exchange ----------------
    #
    # The reference overlaps communication with interior compute by
    # splitting `communicate` into begin/finish (communication/ir/
    # IR_Communicate.scala:31, IR_SplitLoops.scala).  exchange_start posts
    # every neighbour message from the CURRENT array; exchange_finish
    # waits for them and writes the slabs.  All sends leave from the
    # pre-exchange array (no axis sequencing), so CORNER ghosts are not
    # refreshed: valid for radius-1 star operators, which never read
    # corners.

    def exchange_start(self, x: torch.Tensor, local_cells: Tuple[int, ...]) -> _Pending:
        """Post all axis-neighbour messages; returns the pending slabs."""
        self.stats.calls += 1
        sends, recvs = [], []
        for d in range(self.ndim):
            if self.P[d] == 1:
                continue
            s, r = self._axis_messages(x, d, local_cells[d])
            sends += s
            recvs += r
        return self._post(sends, recvs, x.device)

    def exchange_finish(self, x: torch.Tensor, pending: _Pending,
                        local_cells: Tuple[int, ...]) -> torch.Tensor:
        """A copy of x with the slabs of exchange_start written (the same
        per-plane rule as `exchange`); `pending` may be finished into
        several arrays."""
        slabs = pending.result()
        out = x.clone()
        for d in range(self.ndim):
            if self.P[d] > 1:
                self._write(out, d, slabs)
        return out

    def dup_plane_mask(self, shape: Tuple[int, ...], local_cells: Tuple[int, ...], device):
        """True on the dup planes of sharded dims (the only points whose
        radius-1 stencil reads ghost data), None with no sharded dim."""
        m = None
        for d in range(self.ndim):
            if self.P[d] == 1:
                continue
            g = self.ghosts[d]
            i = _iota(shape, d, device)
            mm = (i == g) | (i == g + local_cells[d])
            m = mm if m is None else m | mm
        return m

    # ---------------- masks / coordinates ----------------
    def global_index_1d(self, d: int, size: int, local_cells: Tuple[int, ...], device):
        """Global node index of each local entry along d (ghosts included,
        may be negative / beyond at boundaries)."""
        base = self.axis_index(d) * local_cells[d] - self.ghosts[d]
        return torch.arange(size, device=device) + base

    def owned_mask(self, shape: Tuple[int, ...], local_cells: Tuple[int, ...], device):
        """True where this rank owns the DOF (each global node exactly
        once): nodes [g+1 .. g+n], plus g on the physical lo boundary."""
        lay = self.layout(tuple(local_cells))
        m = None
        for d in range(self.ndim):
            sl = lay.owned_slice(d, at_lo_boundary=self.is_lo_boundary(d))
            i = _iota(shape, d, device)
            own = (i >= sl.start) & (i < sl.stop)
            m = own if m is None else m & own
        return torch.broadcast_to(m, tuple(shape))

    def index_offsets(self, local_cells: Tuple[int, ...]) -> Tuple[int, ...]:
        """Global-minus-local index offset per dim (for colour parity)."""
        return tuple(self.axis_index(d) * local_cells[d] - self.ghosts[d]
                     for d in range(self.ndim))

    def local_coords(self, grid, local_cells: Tuple[int, ...], shape: Tuple[int, ...]):
        """Physical node coordinates of the local entries (broadcastable),
        the sharded analogue of LevelGrid.coord_mesh."""
        out = []
        for d in range(self.ndim):
            gi = self.global_index_1d(d, shape[d], local_cells, grid.device)
            c = grid.domain.aabb.lower[d] + grid.grid_width(d) * gi.to(grid.dtype)
            bshape = [1] * self.ndim
            bshape[d] = shape[d]
            out.append(c.reshape(bshape))
        return tuple(out)

    # ---------------- reductions ----------------
    def _all_reduce(self, v: torch.Tensor, op) -> torch.Tensor:
        if self.mesh is None or not dist.is_initialized():
            raise RuntimeError("a sharded reduction needs this rank's mesh and process group")
        buf = v.to("cpu") if self._staged(v) else v.clone()
        dist.all_reduce(buf, op=op, group=self.mesh.group)
        return buf.to(v.device)

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(v, dist.ReduceOp.SUM)

    def pmax(self, v: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(v, dist.ReduceOp.MAX)


def _iota(shape, d: int, device) -> torch.Tensor:
    """Index along d, shaped to broadcast against `shape`."""
    view = [1] * len(shape)
    view[d] = shape[d]
    return torch.arange(shape[d], device=device).reshape(view)


# ----------------------------------------------------------------------
# host-side conversion: dense global <-> fragment-stacked
# ----------------------------------------------------------------------


def dense_to_fragments(dense: np.ndarray, topo: ShardTopology, local_cells) -> np.ndarray:
    """Scatter a dense global node array ((N_d+1) per dim) into the
    stacked representation (P_d * (n_d+1+2g) per dim) with overlapping
    dup planes and zero ghosts (test/IO utility)."""
    gs = topo.ghosts
    dense = np.asarray(dense)
    loc = topo.local_shape(tuple(local_cells))
    out = np.zeros(tuple(p * t for p, t in zip(topo.P, loc)), dense.dtype)
    for fidx in np.ndindex(*topo.P):
        block = np.zeros(loc, dense.dtype)
        src = tuple(slice(f * n, f * n + n + 1) for f, n in zip(fidx, local_cells))
        block[tuple(slice(g, g + n + 1) for g, n in zip(gs, local_cells))] = dense[src]
        dst = tuple(slice(f * t, (f + 1) * t) for f, t in zip(fidx, loc))
        out[dst] = block  # ghosts stay zero; exchange() fills them on the device
    return out


def fragments_to_dense(stacked: np.ndarray, topo: ShardTopology, local_cells) -> np.ndarray:
    """Gather owned entries back into the dense global node array."""
    gs = topo.ghosts
    loc = topo.local_shape(tuple(local_cells))
    shape = tuple(p * n + 1 for p, n in zip(topo.P, local_cells))
    dense = np.zeros(shape, stacked.dtype)
    for fidx in np.ndindex(*topo.P):
        src = tuple(slice(f * t + g, f * t + g + n + 1)
                    for f, t, n, g in zip(fidx, loc, local_cells, gs))
        dst = tuple(slice(f * n, f * n + n + 1) for f, n in zip(fidx, local_cells))
        dense[dst] = np.asarray(stacked[src])
    return dense


# ----------------------------------------------------------------------
# DSL fragments: windows of the true grid, of any localization, with
# unequal fragments, unsharded dims and lead/trail dims
# ----------------------------------------------------------------------


@dataclass
class DslExchangeStats(ExchangeStats):
    """ExchangeStats of the sharded DSL: `calls` counts every exchange,
    `communicate` those of `communicate` statements, `implicit` those
    before an offset read of a field written since its last exchange;
    `gathers` counts fields gathered whole (sequential sweeps across a
    rank border, transfers into a replicated level, field IO) and
    `seq_gathered` the sequential sweeps run on gathered fields."""

    communicate: int = 0
    implicit: int = 0
    gathers: int = 0
    seq_gathered: int = 0


@dataclass(frozen=True)
class FieldWindow:
    """The geometry of one field instance (a level and a localization) on
    one rank.  Along each dim: `n` global points; if `sharded`, the ranks
    of the mesh axis own contiguous runs starting at `starts` (the last
    run ends at n), and this rank (mesh coordinate `coords[d]`) holds its
    run widened by `ghost` points on each side that has a neighbour (the
    window is clipped at the physical boundary, so the array edge there
    is the grid edge, as in the dense executor).  A replicated dim is held
    whole.  Node fields thus hold the shared border plane on both ranks:
    it is owned by the right one (the first point of its run), as the
    reference's fragment sweep assigns it."""

    n: Tuple[int, ...]
    sharded: Tuple[bool, ...]
    starts: Tuple[Optional[Tuple[int, ...]], ...]
    coords: Tuple[int, ...]
    ghost: int

    @property
    def ndim(self) -> int:
        return len(self.n)

    def own(self, d: int, c: Optional[int] = None) -> Tuple[int, int]:
        """Global [start, stop) owned by mesh coordinate c (default: this
        rank's) along d; the whole dim where replicated."""
        if not self.sharded[d]:
            return 0, self.n[d]
        st = self.starts[d]
        c = self.coords[d] if c is None else c
        return st[c], (st[c + 1] if c + 1 < len(st) else self.n[d])

    def bounds(self, d: int) -> Tuple[int, int]:
        """Global [lo, hi) of the local array along d."""
        s, e = self.own(d)
        if not self.sharded[d]:
            return s, e
        return max(0, s - self.ghost), min(self.n[d], e + self.ghost)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(b[1] - b[0] for b in (self.bounds(d) for d in range(self.ndim)))

    @property
    def any_sharded(self) -> bool:
        return any(self.sharded)

    def owned_local(self, d: int) -> slice:
        lo = self.bounds(d)[0]
        s, e = self.own(d)
        return slice(s - lo, e - lo)


class FragmentWindows:
    """Halo exchange, gathers and reductions of the sharded DSL over one
    rank mesh.  Each field instance is a local array laid out by its
    FieldWindow (spatial dims after `lead` leading slot dims, before any
    trailing matrix dims).

    exchange: along each sharded dim in turn (so edges and corners
    resolve), the `ghost` owned points next to each border go to the
    neighbour's ghost points; the owner of a shared node plane sends it
    too, so after an exchange every ghost point holds its owner's value.
    gather: every rank gets the whole global array (all_gather of the
    owned boxes).  Reductions: `all_reduce` over the mesh's group, so
    every rank gets the same bits.  Transport as ShardTopology: CUDA
    tensors through pinned host buffers under gloo."""

    def __init__(self, mesh, ghost: int):
        self.mesh = mesh
        self.ghost = int(ghost)
        self.stats = DslExchangeStats()
        self._topo = ShardTopology(mesh, tuple(mesh.shape), tuple(mesh.axis_names), ghost,
                                   stats=self.stats)

    def window(self, n, sharded, starts) -> FieldWindow:
        return FieldWindow(tuple(n), tuple(sharded), tuple(starts), self.mesh.coords,
                           self.ghost)

    # ---------------- halo exchange ----------------
    def exchange(self, x: torch.Tensor, w: FieldWindow, lead: int = 0,
                 kind: str = "implicit") -> torch.Tensor:
        """A copy of x whose ghost points hold their owners' values."""
        if not w.any_sharded:
            return x
        t0 = self._topo._tic(x)
        if kind == "communicate":
            self.stats.communicate += 1
        else:
            self.stats.implicit += 1
        g, nd = self.ghost, x.dim()
        out = x.clone()
        c = list(self.mesh.coords)
        for d in range(w.ndim):
            if not w.sharded[d]:
                continue
            ad = lead + d
            lo = w.bounds(d)[0]
            s, e = w.own(d)
            sends, recvs = [], []
            tagged = tuple(out.shape)
            if c[d] > 0:
                peer = self.mesh.peer(c[:d] + [c[d] - 1] + c[d + 1:])
                sends.append(((d, -1) + tagged, out[_sl(nd, ad, s - lo, s - lo + g)], peer,
                              2 * d + 1))
                recvs.append(((d, +1) + tagged, out[_sl(nd, ad, s - lo - g, s - lo)], peer,
                              2 * d))
            if c[d] < self.mesh.shape[d] - 1:
                peer = self.mesh.peer(c[:d] + [c[d] + 1] + c[d + 1:])
                sends.append(((d, +1) + tagged, out[_sl(nd, ad, e - lo - g, e - lo)], peer,
                              2 * d))
                recvs.append(((d, -1) + tagged, out[_sl(nd, ad, e - lo, e - lo + g)], peer,
                              2 * d + 1))
            slabs = self._topo._post(sends, recvs, x.device).result()
            if (d, +1) + tagged in slabs:
                out[_sl(nd, ad, s - lo - g, s - lo)] = slabs[(d, +1) + tagged]
            if (d, -1) + tagged in slabs:
                out[_sl(nd, ad, e - lo, e - lo + g)] = slabs[(d, -1) + tagged]
        self._topo._toc(x, t0)
        return out

    # ---------------- whole arrays ----------------
    def _box(self, w: FieldWindow, coords) -> Tuple[slice, ...]:
        return tuple(slice(*w.own(d, coords[d])) for d in range(w.ndim))

    def gather(self, x: torch.Tensor, w: FieldWindow, lead: int = 0,
               keep=None) -> torch.Tensor:
        """The whole global array on every rank (the owned boxes of all
        ranks, all-gathered; with `keep`, a predicate on mesh coordinates,
        those of the ranks it keeps, in rank order)."""
        if not w.any_sharded and keep is None:
            return x
        self.stats.gathers += 1
        head, tail = tuple(x.shape[:lead]), tuple(x.shape[lead + w.ndim:])
        mine = x[(slice(None),) * lead + tuple(w.owned_local(d) for d in range(w.ndim))]
        boxes = [self._box(w, np.unravel_index(r, self.mesh.shape))
                 for r in range(self.mesh.size)]
        sizes = [int(np.prod([b.stop - b.start for b in box])) * int(np.prod(head + tail))
                 for box in boxes]
        staged = x.is_cuda and self.mesh.backend == "gloo"
        dev = torch.device("cpu") if staged else x.device
        buf = torch.zeros(max(sizes), dtype=x.dtype, device=dev)
        flat = mine.reshape(-1).to(dev)
        buf[: flat.numel()] = flat
        parts = [torch.empty_like(buf) for _ in boxes]
        dist.all_gather(parts, buf, group=self.mesh.group)
        full = torch.empty(head + w.n + tail, dtype=x.dtype, device=x.device)
        for r, (box, size, part) in enumerate(zip(boxes, sizes, parts)):
            if keep is not None and not keep(np.unravel_index(r, self.mesh.shape)):
                continue
            shape = head + tuple(b.stop - b.start for b in box) + tail
            full[(slice(None),) * lead + box] = part[:size].reshape(shape).to(x.device)
        return full

    @staticmethod
    def window_of(full: torch.Tensor, w: FieldWindow, lead: int = 0) -> torch.Tensor:
        """This rank's window of a whole global array."""
        return full[(slice(None),) * lead
                    + tuple(slice(*w.bounds(d)) for d in range(w.ndim))].contiguous()

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s tensor on every rank (same shape and dtype)."""
        staged = t.is_cuda and self.mesh.backend == "gloo"
        buf = t.to("cpu") if staged else t.clone()
        dist.broadcast(buf, self.mesh.peer(np.unravel_index(src, self.mesh.shape)),
                       group=self.mesh.group)
        return buf.to(t.device)

    # ---------------- reductions ----------------
    def owned_mask(self, w: FieldWindow, device) -> Optional[torch.Tensor]:
        """True on the points this rank counts in a reduction: its owned
        run along sharded dims; along a replicated dim every point on the
        ranks at coordinate 0 of that axis and none elsewhere (so a global
        sum counts each point once).  None when no dim is sharded (every
        rank then reduces the whole array itself, with no message)."""
        if not w.any_sharded:
            return None
        m = None
        shape = w.shape
        for d in range(w.ndim):
            i = _iota(shape, d, device)
            if w.sharded[d]:
                sl = w.owned_local(d)
                mm = (i >= sl.start) & (i < sl.stop)
            elif self.mesh.shape[d] > 1 and self.mesh.coords[d] != 0:
                mm = i < 0
            else:
                continue
            m = mm if m is None else m & mm
        return torch.ones(shape, dtype=torch.bool, device=device) if m is None \
            else torch.broadcast_to(m, shape)

    def all_reduce(self, v: torch.Tensor, op: str) -> torch.Tensor:
        """`op` ("sum", "prod", "min", "max") of a 0-d or small tensor
        over the mesh's ranks; every rank gets the same bits."""
        red = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
               "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op]
        return self._topo._all_reduce(v, red)
