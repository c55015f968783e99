"""Staged execution: CUDA-graph capture and replay, and device-side loops.

Reference: `jax.jit` and `lax.while_loop` as the JAX package uses them:
the jitted cycle and residual norm (exastencils_tpu/solver/mg.py:220-253,
parallel/backend.py:132-133), the device-resident solve and CG loops
(solver/mg.py:255-271, solver/krylov.py:57-82) and the DSL's staged
statement runs with their early-exit loops (dsl/interp_staging.py).

A `Recording` holds a run of device work, written as a closure that
reads static input buffers and writes its results back into static
buffers (`Tensor.copy_` inside the run), recorded once and replayed:
- on CUDA it is a fixed sequence of steps: segments captured as
  `torch.cuda.CUDAGraph`s, and device loops whose body is itself such a
  sequence.  All graphs of one recording share one private memory pool
  (they always replay in the order they were captured); recordings never
  share a pool.
- on the CPU, which only tests ask for, nothing is captured: a replay
  re-runs the closure on the same static buffers, so the callers' cache
  keys, buffer binding and write-back run as they do on the card.

Before a recording is made, its closure runs twice on copies of its
inputs (`warm_up`), on the stream that captures: once plainly, which
builds the kernel library, the plans, the caches and the cuBLAS
workspace, and once with host reads forbidden (`no_host_reads`: on CUDA
`torch.cuda.set_sync_debug_mode("error")`, on every device the `Tensor`
methods that read a value on the host raise `HostRead`), so a host read
inside a run shows up before capture, as a failed trace does in JAX.

`device_loop` is the counterpart of `lax.while_loop`: a body run with a
device `done` flag and a device iteration count.  Masked loops update
their carry through `torch.where(done, old, new)`, so iterations after the
exit are no-ops bit for bit, and read `done` on the host once per chunk of
iterations; unmasked loops read it before every iteration and may update
their carry in place.  A loop that cannot exit runs its iterations with no
read at all.

Kernel wrappers count their launches through `count_launch`: eagerly on
the wrapper's `.launches`, during a capture into the recording, which adds
the captured launches to the wrappers' counts at every replay.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import gc
import time
import warnings
from collections import Counter, OrderedDict
from dataclasses import asdict, dataclass
from typing import Callable, List, Optional, Sequence

import torch

# Iterations of a masked device loop between two host reads of its done
# flag (PERF.md: the coarse solves of the 3D paths exit within one
# iteration, so a longer chunk only adds masked no-op iterations).
LOOP_CHUNK = 1
# Bindings of one Staged callable kept at a time (least recently used out).
MAX_BINDINGS = 4


class HostRead(RuntimeError):
    """A device value was read on the host inside a staged run."""


class UnscannedWrite(RuntimeError):
    """A staged run wrote state its static reference scan did not find."""


def is_host_read(err: BaseException) -> bool:
    """True for the failures that leave a DSL run eager: a host read in
    the warm-up (`HostRead`, or CUDA's sync debug error) or a state key
    the scan missed."""
    if isinstance(err, (HostRead, UnscannedWrite)):
        return True
    return isinstance(err, RuntimeError) and "synchronizing CUDA operation" in str(err)


@dataclass
class StageStats:
    """Counters of one staged callable or one DSL executable."""

    captures: int = 0
    replays: int = 0
    graphs: int = 0  # CUDA graphs captured (segments and loop bodies)
    segments: int = 0  # graphs outside loop bodies
    loops: int = 0  # device loops recorded
    host_reads: int = 0  # reads of a loop's done flag, during replays
    capture_s: float = 0.0  # warm-up and capture, seconds
    pool_bytes: int = 0  # device memory the graph pools reserved
    unstaged: int = 0  # DSL runs left eager (host read or missed state key)

    def as_dict(self) -> dict:
        return asdict(self)


# ----------------------------------------------------------------------
# mode of the code now running: eager (None), warm-up, capture or the CPU
# replay of a recording
# ----------------------------------------------------------------------


@dataclass
class _Ctx:
    mode: str  # "warmup" | "capture" | "replay"
    rec: Optional["Recording"] = None


_CTX: contextvars.ContextVar = contextvars.ContextVar("exastencils_staging", default=None)


def capturing() -> bool:
    """True while a recording captures CUDA graphs."""
    ctx = _CTX.get()
    return ctx is not None and ctx.mode == "capture"


def count_launch(wrapper, n: int = 1):
    """Count `n` launches of `wrapper`'s kernel: on its `.launches` when
    they run, into the recording when they are captured (a replay adds
    them then)."""
    ctx = _CTX.get()
    if ctx is not None and ctx.mode == "capture":
        ctx.rec._tally[wrapper] += n
    else:
        wrapper.launches += n


@contextlib.contextmanager
def _mode(mode: str, rec=None):
    token = _CTX.set(_Ctx(mode, rec))
    try:
        yield
    finally:
        _CTX.reset(token)


# ----------------------------------------------------------------------
# host reads
# ----------------------------------------------------------------------

_READS = ("__bool__", "__float__", "__int__", "__index__", "__complex__", "item", "tolist",
          "numpy")
_MISSING = object()


class _Guard:
    """Process-wide, as the patched `torch.Tensor` methods are: `depth`
    counts open `no_host_reads` scopes, `allowed` the reads the staging
    code makes itself inside them."""

    depth = 0
    allowed = 0
    saved: list = []
    sync_mode = None


def _forbidden(name: str, orig):
    def method(self, *args, **kwargs):
        if _Guard.allowed:
            return orig(self, *args, **kwargs)
        raise HostRead(f"Tensor.{name} reads a device value on the host inside a staged run")

    return method


@contextlib.contextmanager
def no_host_reads(device):
    """Make a host read of a tensor value raise: `HostRead` from the
    patched `torch.Tensor` methods, and on CUDA the sync debug error of
    any other synchronizing operation."""
    device = torch.device(device)
    if _Guard.depth == 0:
        _Guard.saved = [(n, torch.Tensor.__dict__.get(n, _MISSING)) for n in _READS]
        for n in _READS:
            setattr(torch.Tensor, n, _forbidden(n, getattr(torch.Tensor, n)))
        if device.type == "cuda":
            _Guard.sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
    _Guard.depth += 1
    try:
        yield
    finally:
        _Guard.depth -= 1
        if _Guard.depth == 0:
            for n, v in _Guard.saved:
                if v is _MISSING:
                    delattr(torch.Tensor, n)
                else:
                    setattr(torch.Tensor, n, v)
            if _Guard.sync_mode is not None:
                torch.cuda.set_sync_debug_mode(_Guard.sync_mode)
                _Guard.sync_mode = None


def read_flag(flag: torch.Tensor, stats: Optional[StageStats] = None) -> bool:
    """`bool(flag)`: the one host read a device loop makes per chunk (or
    an early exit per call), allowed inside `no_host_reads`."""
    if stats is not None:
        stats.host_reads += 1
    _Guard.allowed += 1
    sync = _Guard.sync_mode is not None and flag.is_cuda
    if sync:
        torch.cuda.set_sync_debug_mode(0)
    try:
        return bool(flag)
    finally:
        if sync:
            torch.cuda.set_sync_debug_mode("error")
        _Guard.allowed -= 1


# ----------------------------------------------------------------------
# recordings
# ----------------------------------------------------------------------


@functools.cache
def _side_stream(index: int):
    """The stream that warms up and captures on CUDA device `index`."""
    return torch.cuda.Stream(torch.device("cuda", index))


@contextlib.contextmanager
def _on_side_stream(device: torch.device):
    """Run on the capture stream, ordered after and before the current
    stream's work."""
    if device.type != "cuda":
        yield
        return
    cur = torch.cuda.current_stream(device)
    side = _side_stream(device.index if device.index is not None else torch.cuda.current_device())
    side.wait_stream(cur)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        cur.wait_stream(side)


def warm_up(fn: Callable[[], object], device):
    """Run `fn` twice before a capture (it must work on copies of the
    recording's inputs): plainly, then with host reads forbidden.  Device
    loops run one iteration each in the warm-up."""
    device = torch.device(device)
    with _on_side_stream(device), _mode("warmup"):
        fn()
        with no_host_reads(device):
            fn()


@dataclass
class _Graph:
    graph: object  # torch.cuda.CUDAGraph
    tally: Counter  # wrapper -> launches captured


@dataclass
class _Loop:
    body: list  # steps
    n: int
    chunk: int
    done: torch.Tensor
    masked: bool
    exits: bool
    first_read: bool  # unmasked: read done before the first iteration too


class Recording:
    """A closure's device work, recorded once (`capture`) and replayed
    (`replay`).  `fn()` reads static buffers and writes its results back
    into static buffers; on CUDA it runs once, inside the capture."""

    def __init__(self, fn: Callable[[], object], device, stats: StageStats):
        self.fn = fn
        self.device = torch.device(device)
        self.stats = stats
        self.steps: list = []
        self._open: List[list] = []
        self._graph = None
        self._tally: Counter = Counter()
        self._pool = None

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def capture(self):
        t0 = time.perf_counter()
        if self.cuda:
            # as torch.cuda.graph does: collect the garbage first (the pools
            # of dead recordings go back), and let no collection run during
            # the capture, where destroying another graph is refused
            gc.collect()
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(self.device)
            self._pool = torch.cuda.graph_pool_handle()
            self._open = [self.steps]
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with _on_side_stream(self.device), _mode("capture", self), \
                        warnings.catch_warnings():
                    # a segment between two loops may hold no kernel
                    warnings.filterwarnings("ignore", message=".*CUDA Graph is empty.*")
                    self._begin()
                    try:
                        self.fn()
                    except BaseException:
                        self._abort()
                        raise
                    self._end()
            finally:
                if gc_on:
                    gc.enable()
            torch.cuda.synchronize(self.device)
            self.stats.pool_bytes += torch.cuda.memory_reserved(self.device) - before
        self.stats.captures += 1
        self.stats.capture_s += time.perf_counter() - t0

    def replay(self):
        self.stats.replays += 1
        if not self.cuda:
            with _mode("replay", self):
                self.fn()
            return
        self._run(self.steps)

    # --- capture ---
    def _begin(self):
        self._graph = torch.cuda.CUDAGraph()
        self._tally = Counter()
        self._graph.capture_begin(pool=self._pool)

    def _end(self):
        g, self._graph = self._graph, None
        g.capture_end()
        self._open[-1].append(_Graph(g, self._tally))
        self.stats.graphs += 1
        if len(self._open) == 1:
            self.stats.segments += 1

    def _abort(self):
        """End a capture that raised; the error that made it raise wins."""
        if self._graph is not None:
            g, self._graph = self._graph, None
            try:
                g.capture_end()
            except RuntimeError:
                pass

    def _loop(self, carry, body, n, done, chunk, masked, exits):
        # the loop's buffers and flags start in the open segment
        bufs = [_like(t.clone(), t) for t in carry]
        it = torch.zeros((), dtype=torch.int64, device=self.device)
        dn = done.clone() if done is not None else torch.zeros((), dtype=torch.bool,
                                                               device=self.device)
        self._end()
        steps: list = []
        self._open.append(steps)
        self._begin()
        new, ex = body(list(bufs), it)
        _write_step(bufs, it, dn, new, ex, masked, exits)
        self._end()
        self._open.pop()
        self._open[-1].append(_Loop(steps, n, chunk, dn, masked, exits, done is not None))
        self.stats.loops += 1
        self._begin()
        return bufs, it, dn

    # --- replay ---
    def _run(self, steps):
        for st in steps:
            if isinstance(st, _Graph):
                st.graph.replay()
                for wrapper, k in st.tally.items():
                    wrapper.launches += k
                continue
            done = 0
            if not st.masked:
                while done < st.n:
                    if _read_before(done, st.exits, st.first_read) \
                            and read_flag(st.done, self.stats):
                        break
                    self._run(st.body)
                    done += 1
                continue
            while done < st.n:
                k = min(st.chunk, st.n - done) if st.exits else st.n - done
                for _ in range(k):
                    self._run(st.body)
                done += k
                if done < st.n and read_flag(st.done, self.stats):
                    break


def _like(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """`new` with the Python attributes of the carry value `old` (the
    marks its callers give their values)."""
    if old.__dict__:
        new.__dict__.update(old.__dict__)
    return new


def _read_before(count: int, exits: bool, done_given: bool) -> bool:
    """Whether an unmasked loop reads its done flag before iteration
    `count`: before every iteration when the body can exit, before the
    first when the loop got a done flag."""
    return (exits and count > 0) or (done_given and count == 0)


def _write_step(bufs, it, done, new, exit_flag, masked, exits):
    """One iteration's carry update, in place on the loop's buffers."""
    active = torch.logical_not(done) if masked else None
    final = []
    for b, v in zip(bufs, new):
        if v is b:
            final.append(None)
        elif masked:
            final.append(torch.where(active, v, b))
        else:
            final.append(v.clone() if any(v is x for x in bufs) else v)
    for b, v in zip(bufs, final):
        if v is not None:
            b.copy_(v)
    if exits:
        done.copy_(torch.logical_or(done, exit_flag if active is None
                                    else torch.logical_and(active, exit_flag)))
    it.add_(active.to(it.dtype) if masked else 1)


def _eager_step(bufs, it, done, new, exit_flag, masked, exits):
    """The same update, functional (eager loops, the warm-up and the CPU
    replay): new tensors, nothing written in place."""
    if masked:
        active = torch.logical_not(done)
        bufs = [b if v is b else _like(torch.where(active, v, b), b) for b, v in zip(bufs, new)]
        if exits:
            done = torch.logical_or(done, torch.logical_and(active, exit_flag))
        return bufs, it + active.to(it.dtype), done
    if exits:
        done = torch.logical_or(done, exit_flag)
    return [v if v is b else _like(v, b) for b, v in zip(bufs, new)], it + 1, done


def device_loop(carry: Sequence[torch.Tensor], body, n: int, *, done=None,
                exits: bool = True, masked: bool = True):
    """Up to `n` iterations of `new, exit = body(carry, it)` with a device
    iteration count `it` (int64) and a device `done` flag (`done` given:
    the loop is done before it starts).  Returns (carry, it, done).

    masked: every update is `where(done, old, new)`, the count grows only
    while not done; the host reads `done` after each chunk of LOOP_CHUNK
    iterations, so the iterations after the exit are no-ops bit for bit.  The body must not update its carry in place.
    Unmasked: the host reads `done` before each iteration and runs the
    body only while it is false; the body may update its carry in place.
    exits=False: `body` returns exit None and the loop runs all n
    iterations with no read (and no mask unless `done` is given).

    In a capture the loop becomes a step of the recording (its body one
    captured sequence); in a warm-up it runs one iteration."""
    chunk = LOOP_CHUNK
    n = int(n)
    masked = masked and (exits or done is not None)
    ctx = _CTX.get()
    if ctx is not None and ctx.mode == "capture":
        return ctx.rec._loop(carry, body, n, done, chunk, masked, exits)
    dev = carry[0].device
    bufs = list(carry)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    dn = done if done is not None else torch.zeros((), dtype=torch.bool, device=dev)
    warm = ctx is not None and ctx.mode == "warmup"
    if warm:
        n = min(n, 1)
    reads = ctx.rec.stats if ctx is not None and ctx.rec is not None else None
    count = 0
    while count < n:
        if masked:
            k = min(chunk, n - count) if exits else n - count
            for _ in range(k):
                new, ex = body(bufs, it)
                bufs, it, dn = _eager_step(bufs, it, dn, new, ex, True, exits)
            count += k
            if count < n and not warm and read_flag(dn, reads):
                break
            continue
        if not warm and _read_before(count, exits, done is not None) and read_flag(dn, reads):
            break
        new, ex = body(bufs, it)
        bufs, it, dn = _eager_step(bufs, it, dn, new, ex, False, exits)
        count += 1
    return bufs, it, dn


# ----------------------------------------------------------------------
# staged callables (DenseBackend.wrap on CUDA)
# ----------------------------------------------------------------------


def _identity(a):
    if isinstance(a, torch.Tensor):
        return ("t", a.data_ptr(), tuple(a.shape), tuple(a.stride()), a.dtype, a.device)
    return ("v", a)


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("a staged callable needs a tensor argument")


class _Binding:
    def __init__(self, args, donate):
        self.args = args  # held: the graph reads and writes their storage
        self.donate = donate
        self.rec: Optional[Recording] = None
        self.out = None
        self.tuple_out = False

    def run(self, fn):
        out = fn(*self.args)
        outs = list(out) if isinstance(out, tuple) else [out]
        for i, a in enumerate(self.donate):
            if outs[i] is not self.args[a]:
                self.args[a].copy_(outs[i])  # write back into the caller's storage
                outs[i] = self.args[a]
        self.out, self.tuple_out = outs, isinstance(out, tuple)

    def result(self):
        """The outputs: donated arguments as they are, other tensors cloned
        out of the graph pool."""
        outs = [o if any(o is a for a in self.args) else
                (o.clone() if isinstance(o, torch.Tensor) else o) for o in self.out]
        return tuple(outs) if self.tuple_out else outs[0]


class Staged:
    """`fn(*args)` staged per binding of its arguments: the first call with
    a set of argument tensors (by storage, shape, strides and dtype) warms
    up on copies and captures `fn` on those very tensors; later calls with
    the same tensors replay.  Output i is written back into argument
    `donate[i]` (the iterate of a cycle), any other tensor output is
    returned as a clone.  A host read inside `fn` raises (as a failed jit
    trace does)."""

    def __init__(self, fn: Callable, donate: Sequence[int] = ()):
        self.fn = fn
        self.donate = tuple(donate)
        self.stats = StageStats()
        self._bindings: "OrderedDict[tuple, _Binding]" = OrderedDict()

    def __call__(self, *args):
        key = tuple(_identity(a) for a in args)
        b = self._bindings.get(key)
        if b is None:
            b = self._bind(args)
            self._bindings[key] = b
            while len(self._bindings) > MAX_BINDINGS:
                self._bindings.popitem(last=False)
        else:
            self._bindings.move_to_end(key)
        b.rec.replay()
        return b.result()

    def _bind(self, args) -> _Binding:
        dev = _device_of(args)
        t0 = time.perf_counter()
        warm_up(lambda: self.fn(*[a.clone() if isinstance(a, torch.Tensor) else a
                                  for a in args]), dev)
        self.stats.capture_s += time.perf_counter() - t0
        b = _Binding(args, self.donate)
        b.rec = Recording(functools.partial(b.run, self.fn), dev, self.stats)
        b.rec.capture()
        return b

    def reset(self):
        """Drop every binding (its graphs, pool and held arguments)."""
        self._bindings.clear()
