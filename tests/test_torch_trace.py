"""The spans of the port's solves (runtime/timers), on the CPU at level 4:
the span tree of the ExaSlang benchmark program's `Solve` (staged, CPU
replay) and of the solver API's `solve_fused` and `solve`; nothing
recorded, opened or timed with no profiler running; every span a profiler
range; the host reads counted where they are made; the marks of captured
graphs opened and closed again at each launch; the levels' exclusive
device times summing to the finest level's.  The `cuda` tests time the spans on the card.  This
file imports no jax:

    python -m pytest --noconftest tests/test_torch_trace.py -m cuda
"""

import os
import time
from collections import Counter
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.dsl.interpreter import L4Executable
from exastencils_tpu_torch.dsl.parser import parse_l4
from exastencils_tpu_torch.models.poisson import PoissonMGSolver
from exastencils_tpu_torch.runtime import timers
from portbench import spans as bench_spans

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
BENCH = os.path.join(REPO, "examples", "poisson_3d_bench.exa4")
LEVEL = 4


@pytest.fixture(autouse=True)
def no_spans_left():
    timers.drain()
    yield
    assert not timers.TRACER.stack
    timers.drain()


def bench_program(device="cpu", level=LEVEL, staged=True):
    k = Knowledge(dimensionality=3, minLevel=1, maxLevel=level, useDblPrecision=False,
                  tpu_compute_dtype="float32", tpu_shard_dsl=False).update()
    lines = []
    ex = L4Executable(parse_l4(BENCH), k, device=device, out=lines.append,
                      jit_functions=staged)
    ex.call_function(ex.functions[("InitF", ex.hi)], ex.hi, [])
    return ex, lines


def run_solve(ex, lines):
    """Solve() from a zero guess; the cycles it printed last."""
    lines.clear()
    ex.get_field("U", ex.hi).zero_()
    ex.call_function(ex.functions[("Solve", None)], None, [])
    return int(lines[-1])


def api_solver(device="cpu", level=LEVEL):
    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=level, useDblPrecision=True).update()
    return PoissonMGSolver(k, device=device, cgs="CG")


def traced(fn):
    """fn() under a host-only profiler session; (its result, the spans)."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, timers.drain()


def tree(spans):
    by_id = {s.id: s for s in spans}
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return by_id, kids


def kind_of_parent(spans, kind):
    by_id, _ = tree(spans)
    return Counter(by_id[s.parent].kind for s in spans if s.kind == kind)


def test_dsl_solve_span_tree():
    """One `solve` per Solve() (the root, whose id every span shares), one
    `cycle` per counted cycle with a `level` span for every level of it, and
    the residual checks (`CalcRes`, `ResNorm` on the finest level) before the
    first cycle and after each, inside the replays of the staged runs."""
    ex, lines = bench_program()
    run_solve(ex, lines)  # captures
    cycles, spans = traced(lambda: run_solve(ex, lines))
    roots = [s for s in spans if s.parent is None]
    assert [(r.kind, r.name) for r in roots] == [("solve", "Solve")]
    assert all(s.solve == roots[0].id for s in spans)
    kinds = Counter(s.kind for s in spans)
    assert kinds["cycle"] == cycles == 6
    assert sorted(s.name for s in spans if s.kind == "level") == \
        sorted(f"MGCycle@{lvl}" for lvl in range(1, LEVEL + 1) for _ in range(cycles))
    assert kind_of_parent(spans, "cycle") == {"replay": cycles}
    assert kind_of_parent(spans, "check") == {"replay": 2 * cycles + 2}
    assert kind_of_parent(spans, "replay") == {"solve": cycles + 1}
    assert {s.name for s in spans if s.kind == "check"} == {f"CalcRes@{LEVEL}",
                                                             f"ResNorm@{LEVEL}"}
    order = [s.kind for s in spans if s.kind in ("cycle", "check")]
    assert order == ["check"] * 2 + ["cycle", "check", "check"] * cycles
    by_id, kids = tree(spans)
    for c in (s for s in spans if s.kind == "cycle"):
        (top,) = kids[c.id]
        assert (top.kind, top.name) == ("level", f"MGCycle@{LEVEL}")
    assert all(s.host_end is not None and s.host_end >= s.host_start for s in spans)
    assert all(s.device_ms is None for s in spans)  # no device on the CPU


@pytest.mark.parametrize("entry", ["solve_fused", "solve"])
def test_api_solve_span_tree(entry):
    """`solve_fused` and `solve` of the solver API: a `solve` root, one
    `cycle` per cycle it counts with `level` spans 4..0 nested in it and the
    `coarse` solve in the coarsest, and `check`s (the residual norm) before
    the first cycle and after each."""
    solver = api_solver()
    sol, rhs = solver.init_state()
    if entry == "solve_fused":
        out, spans = traced(lambda: solver.solve_fused(max_its=100, target_res_reduction=1e-10,
                                                       state=(sol.clone(), rhs)))
    else:
        out, spans = traced(lambda: solver.solve(max_its=100, target_res_reduction=1e-10))
    cycles = int(out[3] if entry == "solve_fused" else out[4])
    assert cycles == 10
    roots = [s for s in spans if s.parent is None]
    assert [(r.kind, r.name) for r in roots] == [("solve", entry)]
    assert all(s.solve == roots[0].id for s in spans)
    first = 1 if entry == "solve_fused" else 2  # `solve` prints r0, then its loop takes it
    assert [s.kind for s in spans if s.kind in ("cycle", "check")] == \
        ["check"] * first + ["cycle", "check"] * cycles
    by_id, kids = tree(spans)
    for c in (s for s in spans if s.kind == "cycle"):
        chain, s = [], c
        while s is not None:
            s = next((k for k in kids.get(s.id, ()) if k.kind in ("level", "coarse")), None)
            chain += [] if s is None else [s.name]
        # on the CPU the kernels' wrappers run their plain twins: every level
        # takes the plain route
        assert chain == [f"plain@{lvl}" for lvl in range(LEVEL, -1, -1)] + ["coarse@0"]


def test_no_span_without_a_profiler(monkeypatch):
    """With no profiler session, a solve in either cell's form records no
    span, opens no profiler range and records no event (a CUDA event would
    raise here), and the executor's call is the plain one."""
    def refuse(*args, **kwargs):
        raise AssertionError("opened with spans off")

    monkeypatch.setattr(timers, "_Range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    ex, lines = bench_program()
    run_solve(ex, lines)
    assert run_solve(ex, lines) == 6
    solver = api_solver()
    sol, rhs = solver.init_state()
    assert int(solver.solve_fused(max_its=100, target_res_reduction=1e-10,
                                  state=(sol, rhs))[3]) == 10
    assert not timers.active()
    assert timers.drain() == []


def test_every_span_is_a_profiler_range():
    """Under a CPU profiler every span is a host range `exa.<kind>:<name>`."""
    ex, lines = bench_program()
    run_solve(ex, lines)
    solver = api_solver()
    sol, rhs = solver.init_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_solve(ex, lines)
        solver.solve_fused(max_its=100, target_res_reduction=1e-10, state=(sol, rhs))
    spans = timers.drain()
    ranges = Counter(e.name for e in prof.events() if e.name.startswith("exa."))
    assert ranges == Counter(f"exa.{s.kind}:{s.name}" for s in spans)
    assert {s.kind for s in spans} == {"solve", "replay", "cycle", "level", "check", "coarse",
                                       "host_read"}


READS = ("__bool__", "__float__", "__int__", "__index__", "item")


def count_reads(monkeypatch):
    """Count every read of a tensor value on the host."""
    n = [0]
    for name in READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *args, _orig=orig, **kwargs):
            n[0] += 1
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return n


def reads_per_cycle(spans, solves=1):
    run = SimpleNamespace(solve_trace=None, traffic={"traced_solves": solves})
    bench_spans._drained.update(run=run, spans=spans)
    return bench_spans.host_reads_per_cycle(run)


def test_host_reads_are_counted_where_made(monkeypatch):
    """Every host read a Solve() makes is in its span's count: the coarse
    CG's exit flag (`StageStats.host_reads`), and `print` and the `repeat
    until` test (`StageStats.eager_reads`); per cycle as the benchmark's
    `solve.host_reads_per_cycle` reads it.  The same for `solve_fused`."""
    ex, lines = bench_program()
    run_solve(ex, lines)
    st0 = ex.staging_stats()
    n = count_reads(monkeypatch)
    cycles, spans = traced(lambda: run_solve(ex, lines))
    made = n[0]
    st1 = ex.staging_stats()
    root = spans[0]
    eager = st1["eager_reads"] - st0["eager_reads"]
    assert eager == 2 * cycles + 3  # print(r0), print(r) a cycle, print(it); the tests
    assert made == root.host_reads == eager + st1["host_reads"] - st0["host_reads"]
    assert sum(s.host_reads for s in spans if s.kind == "host_read") == made
    assert reads_per_cycle(spans) == made / cycles == (3 * cycles + 3) / cycles

    solver = api_solver()
    sol, rhs = solver.init_state()
    n[0] = 0
    out, spans = traced(lambda: solver.solve_fused(max_its=100, target_res_reduction=1e-10,
                                                   state=(sol, rhs)))
    assert spans[0].host_reads == n[0] == 2 * int(out[3]) + 1  # loop flag and CG exit a cycle
    assert reads_per_cycle(spans) == 2.1


class FakeEvent:
    """A CUDA event's stand-in: stamped by the fake graph that holds it."""

    def __init__(self, **kwargs):
        self.t = None

    def record(self):
        FakeGraph.capturing.append(self)

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


class FakeGraph:
    """A captured graph's stand-in: the n-th launch stamps its events n ms
    apart."""

    capturing: list = []
    clock = 0.0
    launches = 0

    def __init__(self):
        self.events, FakeGraph.capturing = FakeGraph.capturing, []

    def replay(self):
        FakeGraph.launches += 1
        for ev in self.events:
            FakeGraph.clock += FakeGraph.launches
            ev.t = FakeGraph.clock


def test_captured_spans_open_again_at_each_launch(monkeypatch):
    """Spans met while graphs are captured leave event nodes and marks; each
    launch with spans on opens and closes them again under the replay, with
    device ms from their events (read at the next host read), the host reads
    between graphs and the launches counted; a graph launched again before a
    host read has its earlier events read first."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeGraph.capturing, FakeGraph.clock, FakeGraph.launches = [], 0.0, 0
    with timers.capturing():
        with timers.span("cycle", "V-cycle", 2):  # graph a: cycle opens, level 2 whole
            with timers.span("level", "level", 2):
                pass
            a = (FakeGraph(), timers.take_marks())
            with timers.span("coarse", "coarse", 1):  # graph b: the coarse solve
                pass
            b = (FakeGraph(), timers.take_marks())
        c = (FakeGraph(), timers.take_marks())  # graph c: the cycle closes
    assert not timers.active() and [len(m) for _, m in (a, b, c)] == [3, 2, 1]

    timers.launch(*a)  # spans off: nothing recorded
    assert timers.drain() == []
    FakeGraph.clock, FakeGraph.launches = 0.0, 0

    def solve():
        with timers.span("solve", "solve"), timers.span("replay", "rec"):
            timers.launch(*a)
            timers.launch(*b)
            timers.launch(*b)  # b's events are unread: read before the launch
            with timers.host_read("loop"):
                pass
            timers.launch(*c)
            with timers.host_read("loop"):
                pass

    _, spans = traced(solve)
    assert [(s.kind, s.name) for s in spans] == [
        ("solve", "solve"), ("replay", "rec"), ("cycle", "V-cycle@2"), ("level", "level@2"),
        ("coarse", "coarse@1"), ("coarse", "coarse@1"), ("host_read", "loop"),
        ("host_read", "loop")]
    solve_, replay, cyc, lvl, co1, co2, read1, read2 = spans
    assert [s.parent for s in spans[1:]] == [solve_.id, replay.id, cyc.id, cyc.id, cyc.id,
                                             cyc.id, replay.id]
    # launches 1-4 (a, b, b, c) stamp at t = 1 2 3 | 5 7 | 10 13 | 17
    assert (cyc.device_ms, lvl.device_ms, co1.device_ms, co2.device_ms) == (16.0, 1.0, 2.0, 3.0)
    assert (cyc.replays, cyc.host_reads, replay.replays, replay.host_reads) == (3, 1, 4, 2)
    assert solve_.device_ms is None  # no CUDA in use: the host spans time nothing


def fake_device_events(monkeypatch):
    """CUDA events' stand-ins for the host spans, stamped by the host clock."""
    class HostEvent(FakeEvent):
        def record(self):
            self.t = 1e3 * time.perf_counter()

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)


@pytest.mark.parametrize("staged", [False, True])
def test_level_spans_give_exclusive_times_that_sum_to_the_finest(monkeypatch, staged):
    """The `level` spans of two full cycles (`MGCycle@L`, timed by stand-in
    events on the CPU): a device time for every level, and the exclusive
    times (level L's inclusive time less level L-1's) sum to the finest
    level's inclusive time; `call_function` is the executor's own."""
    fake_device_events(monkeypatch)
    ex, _ = bench_program(staged=staged)
    cyc = ex.functions[("MGCycle", ex.hi)]
    ex.call_function(cyc, ex.hi, [])
    _, spans = traced(lambda: [ex.call_function(cyc, ex.hi, []) for _ in range(2)])
    incl = {}
    for s in spans:
        if s.kind == "level":
            lvl = int(s.name.rsplit("@", 1)[1])
            incl[lvl] = incl.get(lvl, 0.0) + s.device_ms / 2
    excl = {lvl: incl[lvl] - incl.get(lvl - 1, 0.0) for lvl in incl}
    assert sorted(excl) == list(range(1, LEVEL + 1))
    assert all(v >= 0 for v in excl.values())
    assert abs(sum(excl.values()) - incl[LEVEL]) <= 0.01
    assert "call_function" not in vars(ex)


def test_timer_scope_is_a_span():
    """`with timers(name)` is a `timer` span (and still a stopwatch)."""
    reg = timers.TimerRegistry()
    with profile(activities=[ProfilerActivity.CPU]):
        with reg("setup"):
            pass
    (s,) = timers.drain()
    assert (s.kind, s.name, s.parent) == ("timer", "setup", None)
    assert reg.timers["setup"].num_measurements == 1


def test_cli_writes_spans_beside_the_trace(tmp_path):
    """`--trace-dir` writes trace.json and spans.json; every span is a range
    in the trace."""
    import json

    from exastencils_tpu_torch.__main__ import main

    settings, knowledge = tmp_path / "b.settings", tmp_path / "b.knowledge"
    settings.write_text(f'l4file = "{os.path.abspath(BENCH)}"\n')
    knowledge.write_text("dimensionality = 3\nminLevel = 1\nmaxLevel = 3\n")
    assert main(["--cpu", "--trace-dir", str(tmp_path / "t"), str(settings),
                 str(knowledge)]) == 0
    spans = json.loads((tmp_path / "t" / "spans.json").read_text())
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = Counter(e["name"] for e in trace["traceEvents"] if e.get("name", "").startswith("exa."))
    assert names == Counter(f"exa.{s['kind']}:{s['name']}" for s in spans)
    assert [(s["kind"], s["name"]) for s in spans if s["parent"] is None] == \
        [("solve", "Application")]
    assert sum(s["kind"] == "cycle" for s in spans) > 0


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: spans time graphs and kernels there")
    return torch.device("cuda")


def cycle_parts(spans):
    """[(cycle ms, finest level self ms, ms below the finest level)]."""
    by_id, kids = tree(spans)

    def nearest(s, kind):
        out, todo = [], list(kids.get(s.id, ()))
        while todo:
            x = todo.pop()
            (out.append(x) if x.kind == kind else todo.extend(kids.get(x.id, ())))
        return out

    parts = []
    for c in (s for s in spans if s.kind == "cycle"):
        (fin,) = nearest(c, "level")
        inner = sum(x.device_ms for x in nearest(fin, "level"))
        parts.append((c.device_ms, fin.device_ms - inner, inner))
    return parts


def chained_ms(fn, reps: int = 5):
    """(mean ms of fn() over `reps` chained runs between two CUDA events,
    the mean device ms of their `cycle` spans), traced."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU]):
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
    spans = [s.device_ms for s in timers.drain() if s.kind == "cycle"]
    assert len(spans) == reps
    return a.elapsed_time(b) / reps, sum(spans) / reps


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["exa4", "api"])
def test_span_device_times_on_the_card(cuda, cell):
    """At 513^3 on the card, staged as the benchmark's cells run: every span
    of a traced solve timed, by the event nodes captured in the graphs; the
    finest level's self time plus the coarser levels' time is the cycle's
    within 2%; no `exa.` range a device event of the profiler; the solve's
    host reads those the program's counters (`staging_stats()`) made.  Chained
    cycles alone (`MGCycle@finest`, the staged `_cycle`): their spans'
    mean within 10% of the CUDA-event time of the chain; a solve's cycle
    no shorter than that (it may hold more idle time: in `exa4` its graph
    after the coarse CG's exit read also holds the residual checks)."""
    if cell == "exa4":
        ex, lines = bench_program("cuda", 9)
        run_solve(ex, lines)
        cyc = ex.functions[("MGCycle", ex.hi)]

        def solve():
            return run_solve(ex, lines)

        def reads():
            return ex.staging_stats()["host_reads"] + ex.staging_stats()["eager_reads"]

        def cycle():
            ex.call_function(cyc, ex.hi, [])
    else:
        solver = api_solver("cuda", 9)
        sol, rhs = solver.init_state()
        x = sol.clone()

        def solve():
            x.copy_(sol)
            return int(solver.solve_fused(max_its=100, target_res_reduction=1e-10,
                                          state=(x, rhs))[3])

        def reads():
            return solver.gen.staging_stats(100, 1e-10)["host_reads"]

        def cycle():
            solver._cycle(x, rhs)
    solve()
    torch.cuda.synchronize()
    before = reads()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cycles = solve()
        torch.cuda.synchronize()
    spans = timers.drain()
    assert spans[0].kind == "solve" and spans[0].host_reads == reads() - before
    assert not [e.name for e in prof.events() if e.name.startswith("exa.")
                and e.device_type == torch.autograd.DeviceType.CUDA]
    timed = [s for s in spans if s.kind != "host_read"]
    assert all(s.device_ms is not None and s.device_ms > 0 for s in timed)
    parts = cycle_parts(spans)
    assert len(parts) == cycles > 0
    for whole, own, below in parts:
        assert abs(own + below - whole) <= 0.02 * whole
    mean = sum(w for w, _, _ in parts) / cycles
    chained, alone = chained_ms(cycle)
    print(f"{cell}: a solve's cycle span {mean:.3f} ms; chained cycles {chained:.3f} ms by "
          f"events, their spans {alone:.3f} ms")
    assert abs(alone - chained) <= 0.1 * chained
    assert mean >= 0.98 * alone
