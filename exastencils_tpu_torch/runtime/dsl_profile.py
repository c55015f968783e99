"""Where the DSL cycle's time goes, on one CUDA device.

    python -m exastencils_tpu_torch.runtime.dsl_profile [--out DIR]

Runs `MGCycle@finest` of examples/poisson_3d_bench.exa4 (513^3 float32,
minLevel 1, as `chip_smoke.py`'s `dsl_path` builds it) through the L4 executor,
with the fast path and without it, and reports for each:

  cycle_ms_by_block       mean cycle time by CUDA events, four blocks of
                          5 chained cycles, 2 without the fast path (the
                          spread of a host-bound cycle);
  exclusive_ms_by_level   CUDA events around every `MGCycle@L` call during
                          full cycles: inclusive time per level and cycle,
                          minus the next coarser level's;
  device_busy_ms_per_cycle, idle_share
                          the union of device activity in a torch.profiler
                          trace of two cycles, against the last block's
                          cycle time;
  device_kernels_per_cycle, top_kernels_ms_per_cycle, peak_mem_gib.

With the fast path, a cProfile of three cycles (host hot spots) goes to
DIR/dsl_cprofile.txt.  One JSON line per variant goes to stdout, the
whole to DIR/dsl_profile.json when --out is given.
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


def bench_executable(max_level: int, fastpath: bool):
    from exastencils_tpu_torch.dsl.parser import parse_l4

    from exastencils_tpu_torch import Knowledge
    from exastencils_tpu_torch.dsl.interpreter import L4Executable

    k = Knowledge(dimensionality=3, minLevel=1, maxLevel=max_level, useDblPrecision=False,
                  tpu_compute_dtype="float32", tpu_shard_dsl=False,
                  tpu_dsl_fastpath=fastpath).update()
    return L4Executable(parse_l4(BENCH_EXA4), k, device="cuda", out=lambda s: None)


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


def busy_ms(fn, reps: int):
    """(device busy ms per run, top kernels by ms per run, device events
    per run) from a torch.profiler trace of `reps` runs."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    iv, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            iv.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    if not iv:
        raise RuntimeError("torch.profiler recorded no device activity")
    iv.sort()
    busy, (s0, e0) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > e0:
            busy += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    busy += e0 - s0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return busy / reps / 1e3, {n[:70]: round(t / reps / 1e3, 3) for n, t in top}, len(iv) / reps


def per_level_ms(ex, reps: int):
    """Exclusive ms per level and cycle: CUDA events around every
    `MGCycle@L` call during `reps` full cycles, inclusive time of level L
    minus that of L-1."""
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
    return {lvl: round(incl[lvl] - incl.get(lvl - 1, 0.0), 3) for lvl in sorted(incl)}


def profile_variant(max_level: int, fastpath: bool, reps: int, out_dir=None) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    ex = bench_executable(max_level, fastpath)
    fin = ex.hi
    ex.call_function(ex.functions[("InitF", fin)], fin, [])
    cyc = ex.functions[("MGCycle", fin)]

    def run():
        ex.call_function(cyc, fin, [])

    blocks = [round(events_ms(run, reps), 3) for _ in range(4)]
    excl = per_level_ms(ex, reps)
    busy, top, n_kernels = busy_ms(run, 2)
    r = {"cycle_ms_by_block": blocks, "exclusive_ms_by_level": excl,
         "device_busy_ms_per_cycle": round(busy, 3),
         "idle_share": round(1 - busy / blocks[-1], 4),
         "device_kernels_per_cycle": n_kernels, "top_kernels_ms_per_cycle": top}
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    r["peak_mem_gib"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)
    if fastpath and out_dir is not None:
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
    for fastpath in (True, False):
        tag = "fastpath" if fastpath else "plain"
        out[tag] = profile_variant(MAX_LEVEL, fastpath, 5 if fastpath else 2, args.out)
        print(json.dumps({tag: out[tag]}), flush=True)
    if args.out:
        with open(os.path.join(args.out, "dsl_profile.json"), "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
