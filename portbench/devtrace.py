"""Device traces: torch.profiler around a piece of work, read into device
intervals, the operations that took most time and the idle gaps named by
what the host was doing.  The benchmark's own copy of the port's
runtime/dsl_profile.device_events and busy_ms, with the idle share taken
over the host's wall time of the traced work, not only between its first
and last device event.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List

import torch

from portbench.yardstick import gaps_us, union_us

TOP = 10  # entries of each breakdown list
NAMED_GAPS = 2000  # the longest idle gaps named by what the host was doing

def _marker():
    """A kernel that marks where the traced work starts: on an H100 a
    trace lost the device events of its first milliseconds."""
    torch.cuda._sleep(100_000)

def profile(fn: Callable[[], None], reps: int) -> dict:
    """Run fn() once, a marker kernel, then fn() `reps` times under
    torch.profiler.  Returns the device events after the marker as
    (name, start_us, end_us), the host's ops as (name, start_us, end_us),
    and the host's wall seconds of the `reps` runs (each ended by a
    device synchronisation)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        _marker()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        (dev if e.device_type == torch.autograd.DeviceType.CUDA else host).append(iv)
    dev.sort(key=lambda e: e[1])
    marks = [i for i, e in enumerate(dev) if "spin" in e[0] or "sleep" in e[0]]
    if not marks:
        raise RuntimeError("torch.profiler recorded no marker kernel: no device activity traced")
    dev = dev[marks[-1] + 1:]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity after the marker")
    host = [h for h in host if h[2] > dev[0][1]]
    return {"device": dev, "host": host, "wall_s": wall, "reps": reps}

def busy_s(tr: dict) -> float:
    """Seconds in which some operation ran on the device."""
    return union_us((s, e) for _, s, e in tr["device"]) / 1e6

def top_ops(tr: dict) -> List[List]:
    """[name, seconds] of the device operations that took most time."""
    by: Dict[str, float] = {}
    for name, s, e in tr["device"]:
        by[name[:96]] = by.get(name[:96], 0.0) + (e - s) / 1e6
    return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

def idle_gaps(tr: dict) -> List[List]:
    """[what the host was doing, seconds] of the device's idle gaps, the
    NAMED_GAPS longest summed by the innermost host op running at each
    gap's middle ("host between ops" where none ran)."""
    gaps = sorted(gaps_us((s, e) for _, s, e in tr["device"]), key=lambda g: g[0] - g[1])
    host = sorted(tr["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    by: Dict[str, float] = {}
    for gs, ge in gaps[:NAMED_GAPS]:
        mid = 0.5 * (gs + ge)
        name, best = "host between ops", None
        i = bisect.bisect_right(starts, mid)
        for name_h, s, e in reversed(host[max(0, i - 400):i]):
            if e >= mid and (best is None or s > best):
                name, best = name_h, s
        by[name[:96]] = by.get(name[:96], 0.0) + (ge - gs) / 1e6
    return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

def events_ms(fn: Callable[[], None], reps: int) -> float:
    """Mean ms of fn() over `reps` chained runs between two CUDA events,
    after one run (the port's chip_smoke.cuda_ms)."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
