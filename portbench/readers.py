"""What the metrics' readers (portbench/metrics/<name>.py) compute from a
run.  A run carries the window's solves as (seconds, cycles, right-hand
side), its set-up seconds, the program's counters at the end of set-up
and their change over the window, the device memory peak, and in a
traced run on the card the profiler traces of a few solves and of
chained cycles and the CUDA-event time of a cycle.  A reader that finds
nothing to read returns None and the metric is left out of the line."""

from __future__ import annotations

from portbench.devtrace import busy_s
from portbench.yardstick import PEAK_BYTES_S, p95, vcycle_bytes_per_fine_dof


def solve_ms(run):
    """Time to solution: the window's wall time over the solves completed
    in it (host clock)."""
    return 1e3 * run.window_s / len(run.solves)


def solve_ms_p95(run):
    """The 95th percentile of the window's solves' wall times (host clock)."""
    return 1e3 * p95([s for s, _, _ in run.solves])


def peak_mem_gib(run):
    """torch.cuda.max_memory_allocated() over set-up and window, in GiB."""
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30


def setup_s(run):
    """Process start to the first timed solve (host clock)."""
    return run.setup_s


def cycles_per_solve(run):
    """Cycles a solve ran, as the program reports them, over the window."""
    return sum(c for _, c, _ in run.solves) / len(run.solves)


def glups(run):
    """Fine-grid nodes over the CUDA-event time of one V-cycle of chained
    cycles, in 1e9 per second."""
    return None if run.cycle_ms is None else run.fine_dofs / (run.cycle_ms * 1e-3) / 1e9


def kernels_per_cycle(run):
    """Device operations in the trace of chained cycles, per cycle."""
    tr = run.cycle_trace
    return None if tr is None else len(tr["device"]) / tr["reps"]


def host_reads_per_cycle(run):
    """The program's count of host reads of a device loop's exit flag
    (runtime/staging.StageStats.host_reads) over the window, per cycle."""
    cycles = sum(c for _, c, _ in run.solves)
    return run.counters["window"]["host_reads"] / cycles if cycles else None


def capture_s(run):
    """Seconds the program spent warming up and capturing its CUDA graphs
    in set-up (runtime/staging.StageStats.capture_s), on the card."""
    return run.counters["setup"]["capture_s"] if run.cuda else None


def cycle_roofline_share(run):
    """The least time one V-cycle could take over the device's busy time
    per cycle, in %.  The least time: the bytes of a V-cycle whose down
    and up legs are each one pass (yardstick.vcycle_bytes_per_fine_dof)
    times the fine nodes, over the card's published 3.35 TB/s; the busy
    time: the union of the device's activity in the trace of chained
    cycles.  The count is the same whatever kernels implement the cycle."""
    tr = run.cycle_trace
    if tr is None:
        return None
    least = vcycle_bytes_per_fine_dof(run.dtype_bytes, run.ndim) * run.fine_dofs / PEAK_BYTES_S
    return 100.0 * least / (busy_s(tr) / tr["reps"])


def idle_share(run):
    """1 - (union of device activity) / (host wall time of the traced
    solves), in %."""
    tr = run.solve_trace
    return None if tr is None else 100.0 * (1.0 - busy_s(tr) / tr["wall_s"])
