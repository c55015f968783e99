"""The span readers (portbench/spans.py) on the CPU: whole traced runs of
both cells at level 4 under a host-only profiler (which turns the
program's spans on; on the card the harness's own solve trace does), the
idle time they put inside graph replays, and a program without spans."""

import time

import pytest
from torch.profiler import ProfilerActivity, profile

from benchcopy import tiny_checkout
from portbench import harness, spans

CELLS = ("exa4.l9_f32", "api.l9_f64")
SPAN_METRICS = ("solve.check_ms_per_cycle", "cycle.device_ms", "cycle.coarse_ms",
                "solve.host_reads_per_cycle", "staging.launch_idle_ms_per_cycle")
# host reads a cycle at level 4: exa4 6 cycles, each a CG exit, a loop test
# and a print, and per solve print(r0), print(it) and the last test; api 10
# cycles, each a loop flag and a CG exit, and the first flag
READS = {"exa4.l9_f32": 21 / 6, "api.l9_f64": 21 / 10}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


def traced_run(root, cell):
    with profile(activities=[ProfilerActivity.CPU]):
        result, _ = harness.run_cell(harness.Bench(root), cell, 2 ** 33 + 5, 1.0, True, "cpu",
                                     time.perf_counter())
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_host_reads_and_no_device_time(root, cell):
    """Every new metric is the cell's; on the CPU only the count reads."""
    assert all(m in [x["name"] for x, _ in harness.Bench(root).metrics(cell, "per_layer")]
               for m in SPAN_METRICS)
    result = traced_run(root, cell)
    assert result["correct"]
    got = result["metrics"]
    assert got["solve.host_reads_per_cycle"] == {"value": READS[cell], "unit": "reads/cycle"}
    assert not set(SPAN_METRICS) - {"solve.host_reads_per_cycle"} & set(got)


def test_a_program_without_spans_reads_nothing(root, monkeypatch):
    """As the parent of this benchmark's span readers: no `drain`, no number
    and no error."""
    from exastencils_tpu_torch.runtime import timers

    monkeypatch.delattr(timers, "drain")
    result = traced_run(root, "api.l9_f64")
    assert result["correct"] and not set(SPAN_METRICS) & set(result["metrics"])


class Span:
    def __init__(self, id, kind, name, parent, device_ms=None, host_reads=0):
        self.id, self.kind, self.name, self.parent = id, kind, name, parent
        self.device_ms, self.host_reads = device_ms, host_reads


class Run:
    traffic = {"traced_solves": 2}

    def __init__(self, device, host):
        self.solve_trace = {"device": device, "host": host, "wall_s": 1.0, "reps": 2}


def solve_tree(first, root_name="Solve"):
    """Spans of one traced solve: a root, a replay, two cycles of 10 ms
    with a finest level of 9 ms over a next level of 6, a check of 4 ms
    after each, 7 host reads."""
    s = [Span(first, "solve", root_name, None, 30.0, host_reads=7),
         Span(first + 1, "replay", "Solve.run2", first, 29.0)]
    for k in range(2):
        c = first + 2 + 4 * k
        s += [Span(c, "cycle", "MGCycle@9", first + 1, 10.0),
              Span(c + 1, "level", "MGCycle@9", c, 9.0),
              Span(c + 2, "level", "MGCycle@8", c + 1, 6.0),
              Span(c + 3, "check", "CalcRes@9", first + 1, 4.0)]
    return s


def test_readers_of_the_traced_solves():
    """The last `traced_solves` solve roots that the solve trace names are
    read (not the cycle trace's roots after them): the checks and cycles
    by their device ms, the coarse levels as cycle less the finest level's
    self time, the host reads per cycle, and the device's idle time inside
    the replay ranges, no more than the idle time of the trace."""
    device = [("k", 0.0, 100.0), ("k", 300.0, 400.0), ("k", 900.0, 1000.0)]
    host = [("exa.solve:Solve", 0.0, 1000.0), ("exa.replay:Solve.run2", 50.0, 350.0),
            ("exa.replay:Solve.run2", 380.0, 420.0), ("exa.replay:Solve.run2", 600.0, 950.0)]
    run = Run(device, host)
    spans._drained.update(run=run, spans=solve_tree(0) + solve_tree(100) + solve_tree(200)
                          + solve_tree(300, "MGCycle@9"))
    found = spans.solves(run)
    assert [r.id for r in found.roots] == [100, 200] and found.cycles == 4
    assert spans.check_ms_per_cycle(run) == 4.0
    assert spans.cycle_device_ms(run) == 10.0
    assert spans.cycle_coarse_ms(run) == 10.0 - (9.0 - 6.0)
    assert spans.host_reads_per_cycle(run) == 14 / 4
    # idle gaps 100-300 and 400-900; inside replays 100-300, 400-420 and 600-900
    assert spans.launch_idle_ms_per_cycle(run) == (200 + 20 + 300) / 1e3 / 4
    run2 = Run(device, host[:1])
    spans._drained.update(run=run2, spans=solve_tree(0))
    assert spans.solves(run2) is None and spans.launch_idle_ms_per_cycle(run2) is None
