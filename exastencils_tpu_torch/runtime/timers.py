"""Timing subsystem: named stopwatches, the DSL timer builtins and the
spans of the program's layers.

Reference: exastencils_tpu/runtime/timers.py (same `Timer` and
`TimerRegistry` API).  `timer_syncDevice` becomes
`torch.cuda.synchronize` on a CUDA device before the clock is read, and
the `with timers(name)` scope is a span of kind `timer`.

Spans (the port's own; the reference has none).  A span is one piece of
a solve at a layer boundary: `solve` (the root), `cycle`, `level`
(named by its route, `kernels@L` or `plain@L`, in solver/mg), `coarse`,
`check` (a residual check between cycles), `replay` (the host launching a
recording's graphs), `host_read` (one read of a device value on the host)
and `timer`.  Each holds its name, kind, host start
and end (`time.perf_counter`), parent, the id of its solve (the root's),
its device ms and the host reads and graph launches made while it was
open.

Spans are recorded exactly while a torch.profiler session runs
(`torch.autograd.profiler._is_profiler_enabled`).  Off, a span boundary
is one flag check: nothing is opened, kept or recorded on the device.
On, each span is kept in memory until `drain()` and is a profiler range
named `exa.<kind>:<name>` on the profiler's own clock, beside the
device's events.  The ranges are opened with `RecordFunctionFast`, which
the profiler files as a host op: a user range (`record_function`) makes
the CUDA profiler add a device-side annotation over the kernels it
encloses, which readers of a trace would count as device activity.

Device ms: outside a capture a span records two CUDA events on the
current stream (where CUDA is in use).  Inside a recording
(runtime/staging) the Python code runs once, while the graphs are
captured, so there every span boundary records an event that the graph
captures as a node (`Event(external=True)`), whether spans are on or not,
and leaves a mark in its graph; when a graph is launched with spans on
(`launch`), its marks open and close the spans again on the host, under
the `replay` span.  A span's events are read at the next host read,
before a graph whose events are still unread is launched again (a
launch overwrites them), or in `drain()`.  Inside a warm-up no span is
recorded (its work runs on copies).
"""

from __future__ import annotations

import collections
import contextlib
import json
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

# a profiler range filed as a host op (see the module docstring)
_Range = torch._C._profiler._RecordFunctionFast


@dataclass
class Timer:
    """One named stopwatch (total/last/num)."""

    name: str
    total: float = 0.0
    last: float = 0.0
    num_entries: int = 0
    num_measurements: int = 0
    _start: Optional[float] = None

    def start(self):
        self.num_entries += 1
        if self.num_entries == 1:
            self._start = time.perf_counter()

    def stop(self):
        if self.num_entries == 0:
            raise RuntimeError(f"timer {self.name!r} stopped but not started")
        self.num_entries -= 1
        if self.num_entries == 0:
            self.last = time.perf_counter() - self._start
            self.total += self.last
            self.num_measurements += 1
            self._start = None

    @property
    def mean(self) -> float:
        return self.total / max(self.num_measurements, 1)


class TimerRegistry:
    """Named timer pool + the DSL timer builtins.  `device` is the device
    whose queued work `timer_syncDevice` waits for."""

    # the reference's timer_type backends all map onto time.perf_counter;
    # the value is validated so bogus .knowledge settings surface
    _CLOCKS = ("Chrono", "QPC", "WIN_TIME", "UNIX_TIME", "MPI_TIME",
               "WINDOWS_RDSC", "RDSC")

    def __init__(self, knowledge=None, device=None):
        self.timers: Dict[str, Timer] = {}
        self.knowledge = knowledge
        self.device = torch.device(device) if device is not None else None
        self.sync_device = getattr(knowledge, "timer_syncDevice", True)
        clock = getattr(knowledge, "timer_type", "Chrono")
        if clock not in self._CLOCKS:
            raise ValueError(
                f"timer_type {clock!r} not a reference clock backend "
                f"{self._CLOCKS}")
        self.clock = clock

    def _get(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def _sync(self):
        if self.sync_device and self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- DSL builtins ---
    def start(self, name: str):
        self._sync()
        self._get(name).start()

    def stop(self, name: str):
        self._sync()
        self._get(name).stop()

    def get_total_time(self, name: str) -> float:
        return self._get(name).total * 1e3  # ms, the reference's default unit

    def get_mean_time(self, name: str) -> float:
        return self._get(name).mean * 1e3

    def get_last_time(self, name: str) -> float:
        return self._get(name).last * 1e3

    @contextlib.contextmanager
    def __call__(self, name: str):
        """with timers("solve"): ... -- also a span of kind `timer`."""
        self.start(name)
        with span("timer", name):
            try:
                yield
            finally:
                self.stop(name)

    # --- automatic category timing (timer names autoTime_<CATEGORY>[@level]) ---
    def auto_enabled(self, category: str) -> bool:
        k = self.knowledge
        if k is None or not getattr(k, "timer_automaticTiming", False):
            return False
        return bool({
            "COMM": getattr(k, "timer_automaticCommTiming", False),
            "APPLYBC": getattr(k, "timer_automaticBCsTiming", False),
            "IO": getattr(k, "timer_automaticIOTiming", False),
        }.get(category, False))

    def auto_scope(self, category: str, level: Optional[int] = None):
        """Context manager timing one occurrence of a category; a no-op
        when the category is not enabled."""
        if not self.auto_enabled(category):
            return contextlib.nullcontext()
        name = f"autoTime_{category}"
        if level is not None:
            name = f"{name}@{level}"
        return self(name)

    # --- reporting ---
    def print_all(self, out=print):
        for name in sorted(self.timers):
            t = self.timers[name]
            out(f"Timer {name}: {t.total * 1e3:.6f} ms ({t.num_measurements} measurements)")

    def print_statistics(self, out=print):
        for name in sorted(self.timers):
            t = self.timers[name]
            out(
                f"Timer {name}: total {t.total * 1e3:.6f} ms, "
                f"mean {t.mean * 1e3:.6f} ms, n {t.num_measurements}"
            )

    def as_dict(self) -> Dict[str, float]:
        return {n: t.total for n, t in self.timers.items()}


# ----------------------------------------------------------------------
# spans
# ----------------------------------------------------------------------

MAX_SPANS = 1 << 18  # spans kept between two drains (the oldest go first)


@dataclass
class Span:
    """One timed piece of the program's work."""

    id: int
    kind: str
    name: str
    parent: Optional[int]  # the enclosing span's id
    solve: Optional[int]  # the id of its solve span, shared by every span of one solve
    host_start: float  # time.perf_counter() seconds
    host_end: Optional[float] = None
    device_ms: Optional[float] = None  # None where nothing was timed on the device
    host_reads: int = 0  # host reads made while it was open (itself, for a host read)
    replays: int = 0  # captured graphs launched while it was open

    def as_dict(self) -> dict:
        return asdict(self)


class _Tmpl:
    """A span of a captured graph: its kind, name and the two captured
    events, with the mark lists (graphs) that hold them."""

    __slots__ = ("kind", "name", "start", "end", "start_marks", "end_marks")

    def __init__(self, kind: str, name: str):
        self.kind, self.name = kind, name
        self.start = self.end = self.start_marks = self.end_marks = None


class Tracer:
    """The spans of one process.  Process-wide, as the profiler session
    that turns them on is: `TRACER` is the one instance."""

    CAPTURE, QUIET = "capture", "quiet"

    def __init__(self):
        self.mode: Optional[str] = None  # None | CAPTURE | QUIET
        self.marks: Optional[list] = None  # the graph segment being captured
        self.stack: list = []  # open (span, profiler range, template), innermost last
        self.done = collections.deque(maxlen=MAX_SPANS)
        self.pending: list = []  # (span, start event, end event) not read yet
        self.pending_marks: set = set()  # ids of mark lists with unread events
        self.next_id = 0

    def on(self) -> bool:
        return self.mode is None and _profiler._is_profiler_enabled

    def open(self, kind: str, name: str, reads: int = 0, tmpl=None) -> Span:
        parent = self.stack[-1][0] if self.stack else None
        sid, self.next_id = self.next_id, self.next_id + 1
        solve = parent.solve if parent is not None and parent.solve is not None \
            else (sid if kind == "solve" else None)
        sp = Span(sid, kind, name, None if parent is None else parent.id, solve,
                  time.perf_counter(), host_reads=reads)
        for p, _, _ in self.stack:
            p.host_reads += reads
        rng = _Range(f"exa.{kind}:{name}")
        rng.__enter__()
        self.stack.append((sp, rng, tmpl))
        self.done.append(sp)
        return sp

    def close(self, sp: Span, start=None, end=None):
        """Close `sp` (and any span a failed launch left open inside it)."""
        while self.stack:
            top, rng, _ = self.stack.pop()
            top.host_end = time.perf_counter()
            rng.__exit__(None, None, None)
            if top is sp:
                break
        if start is not None:
            self.pending.append((sp, start, end))

    def read_device_times(self):
        """Every unread span's device ms (waits for its end event)."""
        for sp, a, b in self.pending:
            b.synchronize()
            sp.device_ms = a.elapsed_time(b)
        self.pending.clear()
        self.pending_marks.clear()

    def launch(self, graph, marks: list):
        """graph.replay(); with spans on, the graph's marks open and close
        its spans on the host."""
        if not self.on():
            graph.replay()
            return
        if marks and id(marks) in self.pending_marks:
            self.read_device_times()
        graph.replay()
        for p, _, _ in self.stack:
            p.replays += 1
        for opening, t in marks:
            if opening:
                self.open(t.kind, t.name, tmpl=t)
                continue
            sp = next(s for s, _, tm in reversed(self.stack) if tm is t)
            self.close(sp, t.start, t.end)
            self.pending_marks.update((id(t.start_marks), id(t.end_marks)))

    def mark(self, tmpl: _Tmpl, opening: bool):
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        if opening:
            tmpl.start, tmpl.start_marks = ev, self.marks
        else:
            tmpl.end, tmpl.end_marks = ev, self.marks
        self.marks.append((opening, tmpl))


TRACER = Tracer()


def _device_event():
    """A CUDA event recorded on the current stream, where CUDA is in use."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Open:
    """A span recorded on the host (spans on)."""

    __slots__ = ("kind", "name", "reads", "span", "ev")

    def __init__(self, kind: str, name: str, reads: int = 0):
        self.kind, self.name, self.reads = kind, name, reads

    def __enter__(self) -> Span:
        self.span = TRACER.open(self.kind, self.name, self.reads)
        self.ev = None if self.reads else _device_event()
        return self.span

    def __exit__(self, *exc):
        TRACER.close(self.span, self.ev, None if self.ev is None else _device_event())
        if self.reads:  # the device is past every event recorded so far
            TRACER.read_device_times()
        return False


class _Mark:
    """A span inside a capture: an event node and a mark at each end."""

    __slots__ = ("tmpl",)

    def __init__(self, kind: str, name: str):
        self.tmpl = _Tmpl(kind, name)

    def __enter__(self):
        TRACER.mark(self.tmpl, True)

    def __exit__(self, *exc):
        TRACER.mark(self.tmpl, False)
        return False


_NULL = contextlib.nullcontext()


def active() -> bool:
    """Whether a span boundary does anything now: spans on, or a capture
    taking their marks."""
    mode = TRACER.mode
    return mode == Tracer.CAPTURE or (mode is None and _profiler._is_profiler_enabled)


def span(kind: str, name: str, level: Optional[int] = None):
    """`with span(kind, name[, level]):` one span (named `name@level`
    where a level is given); a no-op with spans off."""
    mode = TRACER.mode
    if mode is None:
        if not _profiler._is_profiler_enabled:
            return _NULL
        return _Open(kind, name if level is None else f"{name}@{level}")
    if mode == Tracer.CAPTURE:
        return _Mark(kind, name if level is None else f"{name}@{level}")
    return _NULL


def host_read(name: str, n: int = 1):
    """`with host_read(name):` `n` reads of device values on the host, a
    span of kind `host_read`; the unread device times are read after it."""
    if TRACER.mode is None and _profiler._is_profiler_enabled:
        return _Open("host_read", name, n)
    return _NULL


@contextlib.contextmanager
def capturing():
    """Spans inside are marks of the graphs being captured
    (runtime/staging.Recording.capture)."""
    prev = (TRACER.mode, TRACER.marks)
    TRACER.mode, TRACER.marks = Tracer.CAPTURE, []
    try:
        yield
    finally:
        TRACER.mode, TRACER.marks = prev


def take_marks() -> list:
    """The marks of the graph segment just captured; the next one starts
    empty."""
    marks, TRACER.marks = TRACER.marks, []
    return marks


@contextlib.contextmanager
def quiet():
    """No span is recorded inside (a recording's warm-up)."""
    prev = TRACER.mode
    TRACER.mode = Tracer.QUIET
    try:
        yield
    finally:
        TRACER.mode = prev


def launch(graph, marks: list):
    """Launch a captured graph (see `Tracer.launch`)."""
    TRACER.launch(graph, marks)


def drain() -> List[Span]:
    """The spans recorded since the last drain, in the order they opened,
    with their device ms read (this waits for the device)."""
    TRACER.read_device_times()
    out = list(TRACER.done)
    TRACER.done.clear()
    return out


def dump(path: str) -> int:
    """drain() into a JSON list at `path`; returns the number of spans."""
    spans = drain()
    with open(path, "w") as f:
        json.dump([s.as_dict() for s in spans], f)
    return len(spans)
