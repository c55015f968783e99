"""Where the DSL cycle's time goes, on one CUDA device.

    python -m exastencils_tpu_torch.runtime.dsl_profile [--out DIR]

Runs `MGCycle@finest` of examples/poisson_3d_bench.exa4 (513^3 float32,
minLevel 1, as `chip_smoke.py`'s `dsl_path` builds it) through the L4
executor in three variants: `staged` (the default: the fast path, and the
statement runs captured as CUDA graphs and replayed), `eager` (the fast
path, `jit_functions=False`) and `plain` (no fast path, eager).  For each:

  cycle_ms_by_block       mean cycle time by CUDA events, four blocks of
                          5 chained cycles, 2 for `plain` (the spread of a
                          host-bound cycle), and one more block after the
                          per-level breakdown (`cycle_ms_after`);
  exclusive_ms_by_level   (eager variants) CUDA events around every
                          `MGCycle@L` call during full cycles: inclusive
                          time per level and cycle, minus the next coarser
                          level's.  They sum to `levels_cycle_ms`, the
                          finest level's inclusive time in those same
                          cycles, which is a cycle time of its own: the
                          events around every level add host work, and the
                          host-bound cycle drifts within a process, so it
                          is compared with the blocks and not summed
                          against them.  A staged cycle is one replay:
                          no level is timed apart;
  device_busy_ms_per_cycle, idle_share
                          the union of device activity in a torch.profiler
                          trace of two cycles (after a cycle and a marker
                          kernel in the same trace, `device_events`), and
                          the share of their device span (first start to
                          last end) with no activity;
  device_kernels_per_cycle, top_kernels_ms_per_cycle, peak_mem_gib;
  staging                 (staged) graphs, segments and device loops
                          captured, host reads per cycle, capture seconds
                          and graph-pool bytes.

With the fast path, eager, a cProfile of three cycles (host hot spots)
goes to DIR/dsl_cprofile.txt.  One JSON line per variant goes to stdout,
the whole to DIR/dsl_profile.json when --out is given.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import io
import json
import os
import pstats

import torch

MAX_LEVEL = 9  # 513^3 nodes
BENCH_EXA4 = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                          "examples", "poisson_3d_bench.exa4")


VARIANTS = {"staged": (True, None), "eager": (True, False), "plain": (False, False)}


def bench_executable(max_level: int, fastpath: bool, jit_functions=None):
    from exastencils_tpu_torch.dsl.parser import parse_l4

    from exastencils_tpu_torch import Knowledge
    from exastencils_tpu_torch.dsl.interpreter import L4Executable

    k = Knowledge(dimensionality=3, minLevel=1, maxLevel=max_level, useDblPrecision=False,
                  tpu_compute_dtype="float32", tpu_shard_dsl=False,
                  tpu_dsl_fastpath=fastpath).update()
    return L4Executable(parse_l4(BENCH_EXA4), k, device="cuda", out=lambda s: None,
                        jit_functions=jit_functions)


def events_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` chained runs, after one."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_events(fn, reps: int):
    """The device events of `reps` runs of fn() in one torch.profiler
    trace, sorted by start.  The trace first runs fn() once and then a
    marker kernel (`torch.cuda._sleep`), and only the events after the
    marker are returned: on an H100 a trace lost the device events of its
    first milliseconds (PERF.md §6)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(ev) if "spin" in e.name or "sleep" in e.name]
    if not marks:
        raise RuntimeError("torch.profiler recorded no marker kernel: no device activity?")
    return ev[marks[-1] + 1:]


def busy_ms(fn, reps: int):
    """(device busy ms per run, top kernels by ms per run, device events
    per run, device idle share) from a torch.profiler trace of `reps` runs
    (`device_events`): busy is the union of the device's activity, the
    idle share its gaps between the first start and the last end."""
    ev = device_events(fn, reps)
    if not ev:
        raise RuntimeError("torch.profiler recorded no device activity")
    iv, by_name = [], {}
    for e in ev:
        iv.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy, (s0, e0) = 0.0, iv[0]
    first, last = iv[0][0], max(e for _, e in iv)
    for s, e in iv[1:]:
        if s > e0:
            busy += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    busy += e0 - s0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return (busy / reps / 1e3, {n[:70]: round(t / reps / 1e3, 3) for n, t in top}, len(iv) / reps,
            1 - busy / (last - first))


def per_level_ms(ex, reps: int):
    """(exclusive ms per level and cycle, the finest level's inclusive ms
    per cycle): CUDA events around every `MGCycle@L` call during `reps`
    full cycles, inclusive time of level L minus that of L-1; the
    exclusive times sum to the inclusive one."""
    fin = ex.hi
    orig = ex.call_function
    ev = {}

    def timed(fn, level, args):
        if fn.name != "MGCycle":
            return orig(fn, level, args)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        r = orig(fn, level, args)
        b.record()
        ev.setdefault(level, []).append((a, b))
        return r

    ex.call_function = timed
    try:
        for _ in range(reps):
            ex.call_function(ex.functions[("MGCycle", fin)], fin, [])
        torch.cuda.synchronize()
    finally:
        ex.call_function = orig
    incl = {lvl: sum(a.elapsed_time(b) for a, b in v) / reps for lvl, v in ev.items()}
    excl = {lvl: round(incl[lvl] - incl.get(lvl - 1, 0.0), 3) for lvl in sorted(incl)}
    return excl, round(incl[fin], 3)


def profile_variant(max_level: int, variant: str, reps: int, out_dir=None) -> dict:
    """The measurements of one variant (VARIANTS) at `max_level`."""
    gc.collect()
    torch.cuda.empty_cache()
    fastpath, jit = VARIANTS[variant]
    ex = bench_executable(max_level, fastpath, jit)
    fin = ex.hi
    ex.call_function(ex.functions[("InitF", fin)], fin, [])
    cyc = ex.functions[("MGCycle", fin)]

    def run():
        ex.call_function(cyc, fin, [])

    run()  # the staged variant captures here
    torch.cuda.synchronize()
    st0 = ex.staging_stats()
    blocks = [round(events_ms(run, reps), 3) for _ in range(4)]
    st1 = ex.staging_stats()
    r = {"variant": variant, "staged": ex.jit_functions, "cycle_ms_by_block": blocks}
    if not ex.jit_functions:
        r["exclusive_ms_by_level"], r["levels_cycle_ms"] = per_level_ms(ex, reps)
        r["levels_sum_ms"] = round(sum(r["exclusive_ms_by_level"].values()), 3)
    r["cycle_ms_after"] = round(events_ms(run, reps), 3)
    busy, top, n_kernels, idle = busy_ms(run, 2)
    r.update(device_busy_ms_per_cycle=round(busy, 3), idle_share=round(idle, 4),
             device_kernels_per_cycle=n_kernels, top_kernels_ms_per_cycle=top)
    if ex.jit_functions:
        cycles = 4 * (reps + 1)  # events_ms runs each block's fn reps + 1 times
        r["staging"] = {
            "graphs": st1["graphs"], "segments": st1["segments"], "loops": st1["loops"],
            "captures": st1["captures"], "unstaged": st1["unstaged"],
            "host_reads_per_cycle": (st1["host_reads"] - st0["host_reads"]) / cycles,
            "capture_s": round(st1["capture_s"], 3), "pool_bytes": st1["pool_bytes"]}
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    r["peak_mem_gib"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)
    if variant == "eager" and out_dir is not None:
        pr = cProfile.Profile()
        pr.enable()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        pr.disable()
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(25)
        with open(os.path.join(out_dir, "dsl_cprofile.txt"), "w") as f:
            f.write(s.getvalue())
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the JSON and the cProfile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dsl_profile needs a CUDA device")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    out = {"device": torch.cuda.get_device_name(0), "max_level": MAX_LEVEL}
    for variant in VARIANTS:
        out[variant] = profile_variant(MAX_LEVEL, variant, 2 if variant == "plain" else 5,
                                       args.out)
        print(json.dumps({variant: out[variant]}), flush=True)
    if args.out:
        with open(os.path.join(args.out, "dsl_profile.json"), "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
