"""The variable-coefficient cell's own arithmetic and readers: the bytes
of one V-cycle whose operator reads coefficient arrays, and the readers
of the metrics that only that cell reports (`cycle.plain_ms`,
`cycle.varcoeff_roofline_share`, `setup.coef_s`).  A reader that finds
nothing to read returns None, as in readers.py and spans.py.
"""

from __future__ import annotations

from portbench.devtrace import busy_s
from portbench.spans import device_ms, solves
from portbench.yardstick import PEAK_BYTES_S, vcycle_bytes_per_fine_dof

ROUTES = ("kernels", "plain")  # the names of the program's `level` spans, before "@"


def varcoeff_vcycle_bytes_per_fine_dof(dtype_bytes: int, ndim: int = 3) -> float:
    """Device-memory bytes per fine-grid node of one V-cycle of one-pass
    legs (yardstick.vcycle_bytes_per_fine_dof) whose operator reads, in
    each of its two legs, one face array per axis of the level's size:
    2 legs x ndim arrays x dtype_bytes, summed over the levels, each
    2^-ndim of the next.  The centre is the negative sum of the face
    coefficients, so a kernel computes it from the arrays it reads.  In
    float64 in 3D, 57.1 + 54.9 = 112.0 bytes."""
    level_sum = 1.0 / (1.0 - 0.5 ** ndim)
    return vcycle_bytes_per_fine_dof(dtype_bytes, ndim) + 2 * ndim * dtype_bytes * level_sum


def plain_ms(run):
    """Device ms per cycle of the traced solves spent in `level` spans
    whose route is `plain` (named `plain@L`), each span's self time (its
    ms less that of the next level's spans inside it), summed.  None where
    no level span names a route."""
    found = solves(run)
    if found is None:
        return None
    levels = found.of_kind("level")
    if not any(s.name.split("@")[0] in ROUTES for s in levels):
        return None
    total = 0.0
    for s in levels:
        if s.name.split("@")[0] != "plain":
            continue
        inner = device_ms(found.nearest(s, "level"))
        if s.device_ms is None or inner is None:
            return None
        total += s.device_ms - inner
    return total / found.cycles


def varcoeff_roofline_share(run):
    """The least time one variable-coefficient V-cycle could take over the
    device's busy time per cycle, in %: varcoeff_vcycle_bytes_per_fine_dof
    times the fine nodes over the card's published 3.35 TB/s, against the
    union of the device's activity in the trace of chained cycles."""
    tr = run.cycle_trace
    if tr is None:
        return None
    least = varcoeff_vcycle_bytes_per_fine_dof(run.dtype_bytes, run.ndim) * run.fine_dofs \
        / PEAK_BYTES_S
    return 100.0 * least / (busy_s(tr) / tr["reps"])


def coef_s(run):
    """Seconds set-up spent building the coefficient arrays: the program's
    `PoissonMGSolver.coef_s` (host clock to a device sync), reported by
    the system's counters.  None where the program reports none."""
    return run.counters["setup"].get("coef_s")
