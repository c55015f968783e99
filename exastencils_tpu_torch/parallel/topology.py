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
