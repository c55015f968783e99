"""One run of one benchmark cell, and everything it finds by name.

A cell of BENCHMARK.json names a configuration and a traffic mix.  The
harness reads, all under the checkout's `portbench/`:

  configs/<file of the configuration>  its settings; `system` and
                                       `reference` name the two files below,
                                       `dtype` the torch dtype of its fields
  systems/<system>.py                  builds the program under test
                                       (class System: load, solve,
                                       solution, norms, cycle, counters)
  references/<reference>.py            the plain reference (solve)
  traffic/<traffic>.json               the generator's parameters
  workloads/<cell>.json                the limits of the cell's check, and
                                       `residual_cycles` where its residual
                                       histories are compared
  metrics/<metric>.py                  one reader per metric (read(run))

Nothing here assumes a dimension or a dtype: the fine grid's size, its
dimension and its bytes per value are read off the system's solution.

A run: make the right-hand sides on the device from the seed, build the
system, solve `warm_solves` times (the traffic's) to warm up: every graph
captured, the kernel library built or loaded, the host's first seconds
spent; then solve back to back for `seconds` (one caller in a
closed loop: each solve resets the guess, copies in the next right-hand
side, solves and synchronises), keeping a copy of the sampled solves'
solutions.  With trace, profile a few more solves and cycles.  Then free
the program, run the plain reference on the sampled right-hand sides and
compare.  The metrics' readers take what they need from the run.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench import devtrace, traffic as traffic_gen

PKG = "portbench"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "exastencils_tpu"})
CYCLE_REPS = 10  # chained cycles between two CUDA events
CYCLE_TRACE_REPS = 2  # cycles in the trace that counts kernels and busy time


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype a configuration names ("float64", "bfloat16", ...)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"{name!r} is not a torch dtype")
    return dtype


def load_file(path: Path, name: str):
    """The module in `path` (a file under the benchmark, found by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """BENCHMARK.json of a checkout and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / PKG
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str):
        """(settings, directory of its file) of the configuration `name`."""
        for c in self.manifest["configs"]:
            if c["name"] == name:
                path = self.root / c["file"]
                return json.loads(path.read_text()), path.parent
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def workload(self, cell: str) -> dict:
        return json.loads((self.dir / "workloads" / f"{cell}.json").read_text())

    def limits(self, cell: str) -> dict:
        return self.workload(cell)["limits"]

    def system(self, cfg: dict):
        return load_file(self.dir / "systems" / f"{cfg['system']}.py",
                         f"{PKG}_systems_{cfg['system']}")

    def reference(self, cfg: dict):
        return load_file(self.dir / "references" / f"{cfg['reference']}.py",
                         f"{PKG}_references_{cfg['reference']}")

    def metrics(self, cell: str, kind: str) -> list:
        """[(metric, read)] of the `end_to_end` or `per_layer` metrics the
        cell reports, each read by metrics/<name>.py."""
        out = []
        for m in self.manifest[kind]:
            if cell in m.get("workloads", [cell]):
                mod = load_file(self.dir / "metrics" / f"{m['name']}.py",
                                f"{PKG}_metrics_{m['name'].replace('.', '_')}")
                out.append((m, mod.read))
        return out


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|, in float64."""
    ref = ref.double()
    return float((got.to(ref.device).double() - ref).abs().max() / ref.abs().max())


def residual_gap(got, ref, cycles: int):
    """How far the residual reductions r_k / r_0 that a solve reported for
    its first `cycles` cycles lie from the reference's:
    max |(got_k / got_0) / (ref_k / ref_0) - 1| over k = 1 .. cycles (fewer
    where the reference stopped sooner).  None where the solve reported
    fewer cycles than that, or nothing."""
    k_max = min(cycles, len(ref) - 1)
    if got is None or len(got) <= k_max or not got[0] > 0:
        return None
    return max((abs(got[k] / got[0] / (ref[k] / ref[0]) - 1.0) for k in range(1, k_max + 1)),
               default=0.0)


def compare(bench: Bench, cfg: dict, level: int, dtype, rhs, order, solves, kept,
            histories=None, residual_cycles=None) -> dict:
    """The plain reference on each sampled right-hand side: the widest
    relative gap of a sampled solution, the largest difference in cycles
    over every window solve of a sampled right-hand side, and, where
    `residual_cycles` is given, the widest gap of those solves' reported
    residual reductions over their first `residual_cycles` cycles (each
    None where no solve was checked), with the reference's cycles, norms
    and solution gap by right-hand side."""
    ref = bench.reference(cfg)
    by_slot = {}
    for i, u in sorted(kept.items()):
        slot = order[i % len(order)]
        t = time.perf_counter()
        u_ref, cycles, norms = ref.solve(cfg, rhs[slot], level, dtype)
        gap = rel_gap(u, u_ref)
        del u_ref
        by_slot[slot] = (cycles, gap, norms)
        print(f"reference: solve {i} (right-hand side {slot}) {cycles} cycles, gap {gap:.6e}, "
              f"{time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    checked = [(c, by_slot[s][0]) for _, c, s in solves if s in by_slot]
    found = {"solution_gap": max((v[1] for v in by_slot.values()), default=None),
             "cycles_gap": max((abs(a - b) for a, b in checked), default=None),
             "by_slot": by_slot, "residual_by_solve": []}
    if residual_cycles is not None:
        found["residual_by_solve"] = [
            residual_gap(h, by_slot[s][2], residual_cycles)
            for (_, _, s), h in zip(solves, histories) if s in by_slot]
        gaps = found["residual_by_solve"]
        found["residual_gap"] = None if not gaps or None in gaps else max(gaps)
    return found


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not measured ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else \
        "not measured"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, each compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float, wrap=None):
    """One run; returns (the result's JSON object, the check's lines).
    `wrap(system)` may stand a changed system in for the built one."""
    cell = bench.cell(workload)
    cfg, cfg_dir = bench.config(cell["config"])
    tr = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    residual_cycles = bench.workload(workload).get("residual_cycles")
    dtype, level = dtype_of(cfg["dtype"]), tr["level"]
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rhs = traffic_gen.bank(tr, seed, dtype, device)
    order = traffic_gen.order(tr, seed)
    picks = set(traffic_gen.samples(tr, seed))
    system = bench.system(cfg).System(cfg, level, device, cfg_dir)
    if wrap is not None:
        system = wrap(system)

    def solve(i: int) -> int:
        system.load(rhs[order[i % len(order)]])
        cycles = system.solve()
        sync()
        return cycles

    # the sampled solutions are copied on the device into buffers made
    # before the warm-up, so the copies take no time from the window and
    # the buffers weigh alike in every run's peak
    kept = {i: torch.empty_like(system.solution()) for i in picks}
    for i in range(tr["warm_solves"]):
        solve(i)
    setup = system.counters()
    setup_s = time.perf_counter() - t0

    solves, histories, done = [], [], set()
    start = time.perf_counter()
    end = deadline = start + seconds
    while not solves or end < deadline:
        i = len(solves)
        t = time.perf_counter()
        cycles = solve(i)
        end = time.perf_counter()
        solves.append((end - t, cycles, order[i % len(order)]))
        histories.append(system.norms())
        if i in kept:
            kept[i].copy_(system.solution())
            done.add(i)
    window_s = end - start
    after = system.counters()
    peak = torch.cuda.max_memory_allocated() if cuda else None

    solve_trace = cycle_trace = cycle_ms = None
    if trace and cuda:
        n = len(solves)
        count = iter(range(n, n + 10 ** 6))
        solve_trace = devtrace.profile(lambda: solve(next(count)), tr["traced_solves"])
        cycle_ms = devtrace.events_ms(system.cycle, CYCLE_REPS)
        cycle_trace = devtrace.profile(system.cycle, CYCLE_TRACE_REPS)
    fine = system.solution()
    grid = {"fine_dofs": fine.numel(), "ndim": fine.dim(), "dtype_bytes": fine.element_size()}
    del system, fine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    kept = {i: u for i, u in kept.items() if i in done}
    found = compare(bench, cfg, level, dtype, rhs, order, solves, kept, histories,
                    residual_cycles)
    numbers = {k: found.get(k) for k in limits}
    wrong = sum(1 for _, c, s in solves
                if s in found["by_slot"] and c != found["by_slot"][s][0])
    wrong += sum(1 for v in found["by_slot"].values() if v[1] > limits["solution_gap"])
    if "residual_gap" in limits:
        wrong += sum(1 for g in found["residual_by_solve"]
                     if g is None or g > limits["residual_gap"])
    correct = all(numbers[k] is not None and numbers[k] <= limits[k] for k in limits)

    run = SimpleNamespace(
        cuda=cuda, config=cfg, traffic=tr, level=level, **grid, setup_s=setup_s,
        window_s=window_s, solves=solves,
        counters={"setup": setup, "window": {k: after[k] - setup[k] for k in setup}},
        peak_bytes=peak, solve_trace=solve_trace, cycle_ms=cycle_ms, cycle_trace=cycle_trace)
    metrics = {}
    for m, read in bench.metrics(workload, "per_layer" if trace else "end_to_end"):
        value = read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": cell["chips"] if cuda else 0, "memory_peak_bytes": peak,
           "power_limit": power_limit() if cuda else "not measured"}
    result = {"correct": correct, "attempted": len(solves), "failed": wrong,
              "metrics": metrics, "device": dev}
    if solve_trace is not None:
        dev["busy_s"] = devtrace.busy_s(solve_trace)
        dev["window_s"] = solve_trace["wall_s"]
        result["breakdown"] = {"device_ops": devtrace.top_ops(solve_trace),
                               "idle_gaps": devtrace.idle_gaps(solve_trace)}
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ms = [1e3 * t for t, _, _ in solves]
    tenth = max(1, len(ms) // 10)
    series = [round(sum(ms[k:k + tenth]) / len(ms[k:k + tenth]), 2)
              for k in range(0, len(ms), tenth)]
    lines = [f"solve ms: min {min(ms):.3f}, median {sorted(ms)[len(ms) // 2]:.3f}, max "
             f"{max(ms):.3f}, mean by tenth of the window {series}",
             f"window: {len(solves)} solves in {window_s:.3f} s, cycles "
             f"{sorted({c for _, c, _ in solves})}, captures in the window "
             f"{after['captures'] - setup['captures']}, runs left eager {after['unstaged']}"]
    if not kept:
        lines.append(f"no sampled solve ({sorted(picks)}) was reached in the window's "
                     f"{len(solves)} solves: nothing was compared")
    lines += [f"check {k} {numbers[k]!r} limit {limits[k]!r}" for k in limits]
    return result, lines


def main(args, root: Path, t0: float) -> int:
    bench = Bench(root)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}, which the port must not import",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
