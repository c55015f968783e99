"""The program's spans (the port's runtime/timers) as the span readers
(portbench/metrics/) read them.

While a torch.profiler session runs, the program records a span at each
layer boundary of a solve (`solve`, `cycle`, `level`, `coarse`, `check`,
`replay`, `host_read`) with its parent, its device ms and the host reads
made inside it, and keeps them until `timers.drain()`.  The first reader
of a run drains them; the readers of that run share what it drained.  The
run's traced solves are the last `traffic["traced_solves"]` solve spans
with no parent whose names the solve trace shows as `exa.solve:<name>`
ranges (the cycle trace after it adds roots of its own).  A program with
no spans (no `drain`) reads as nothing, and so does a run whose trace
holds too few solves.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

from portbench.yardstick import gaps_us

SOLVE_RANGE = "exa.solve:"
REPLAY_RANGE = "exa.replay:"

_drained = {"run": None, "spans": []}


def drained(run) -> list:
    """Every span the program recorded since the last drain, drained once
    per run; [] where the program keeps none."""
    if _drained["run"] is not run:
        try:
            timers = importlib.import_module("exastencils_tpu_torch.runtime.timers")
        except ImportError:
            timers = None
        drain = getattr(timers, "drain", None)
        _drained.update(run=run, spans=drain() if drain is not None else [])
    return _drained["spans"]


class Solves:
    """The span trees of a run's traced solves."""

    def __init__(self, roots: list, spans: list):
        self.roots = roots
        self.children: Dict[int, list] = {}
        for s in spans:
            if s.parent is not None:
                self.children.setdefault(s.parent, []).append(s)
        self.inside: List = []
        todo = list(roots)
        while todo:
            s = todo.pop()
            self.inside.append(s)
            todo.extend(self.children.get(s.id, ()))

    def nearest(self, span, kind: str) -> list:
        """The spans of `kind` below `span` with no span of `kind` between."""
        out, todo = [], list(self.children.get(span.id, ()))
        while todo:
            s = todo.pop()
            if s.kind == kind:
                out.append(s)
            else:
                todo.extend(self.children.get(s.id, ()))
        return out

    def of_kind(self, kind: str) -> list:
        return [s for s in self.inside if s.kind == kind]

    @property
    def cycles(self) -> int:
        return len(self.of_kind("cycle"))


def solves(run) -> Optional[Solves]:
    """The traced solves' span trees, or None."""
    n = getattr(run, "traffic", {}).get("traced_solves")
    spans = drained(run)
    roots = [s for s in spans if s.parent is None and s.kind == "solve"]
    if run.solve_trace is not None:
        traced = {name[len(SOLVE_RANGE):] for name, _, _ in run.solve_trace["host"]
                  if name.startswith(SOLVE_RANGE)}
        roots = [s for s in roots if s.name in traced]
    if n is None or len(roots) < n:
        return None
    found = Solves(roots[-n:], spans)
    return found if found.cycles else None


def device_ms(spans: list) -> Optional[float]:
    """The sum of the spans' device ms; None where one was not timed."""
    if any(s.device_ms is None for s in spans):
        return None
    return sum(s.device_ms for s in spans)


def check_ms_per_cycle(run):
    """Device ms of the `check` spans (residual checks between cycles) of
    the traced solves, per cycle."""
    found = solves(run)
    if found is None:
        return None
    ms = device_ms(found.of_kind("check"))
    return None if ms is None else ms / found.cycles


def cycle_device_ms(run):
    """Device ms of a `cycle` span of the traced solves (their mean): the
    cycle the solve runs, on the timed path."""
    found = solves(run)
    if found is None:
        return None
    ms = device_ms(found.of_kind("cycle"))
    return None if ms is None else ms / found.cycles


def cycle_coarse_ms(run):
    """Device ms per cycle below the finest level: a `cycle` span's device
    ms less the self time of its finest `level` span (its own ms less that
    of the next level's spans inside it), their mean over the traced
    solves' cycles."""
    found = solves(run)
    if found is None:
        return None
    below = []
    for c in found.of_kind("cycle"):
        finest = found.nearest(c, "level")
        if len(finest) != 1:
            return None
        inner, outer = device_ms(found.nearest(finest[0], "level")), device_ms([c, finest[0]])
        if inner is None or outer is None:
            return None
        below.append(c.device_ms - (finest[0].device_ms - inner))
    return sum(below) / len(below)


def host_reads_per_cycle(run):
    """Host reads inside the traced solves' `solve` spans (loop flags,
    the DSL's eager tests and prints), per cycle."""
    found = solves(run)
    if found is None:
        return None
    return sum(r.host_reads for r in found.roots) / found.cycles


def launch_idle_ms_per_cycle(run):
    """Device-idle ms per cycle inside the host's `exa.replay` ranges of the
    solve trace (both on the profiler's clock): the device's gaps between
    its first and last operation, cut to the union of those ranges, over
    the traced solves' cycles."""
    tr = run.solve_trace
    found = solves(run)
    if tr is None or found is None:
        return None
    replays = sorted((s, e) for name, s, e in tr["host"] if name.startswith(REPLAY_RANGE))
    if not replays:
        return None
    merged = []
    for s, e in replays:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    idle_us, i = 0.0, 0
    for gs, ge in gaps_us((s, e) for _, s, e in tr["device"]):
        while i < len(merged) and merged[i][1] <= gs:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < ge:
            idle_us += min(ge, merged[j][1]) - max(gs, merged[j][0])
            j += 1
    return idle_us / 1e3 / found.cycles
