"""The two readings that a cell's check limits are set from.

    python3 portbench/control.py --workload <cell> --seeds <n> ... [--control-seeds <n> ...]
                                 [--out <file>]

`--seeds`: the program's reading on each seed, as a run computes it: the
cell's system solves each sampled right-hand side, and its solution,
cycles and (where the cell's workload file names `residual_cycles`) its
reported residual reductions are compared with the plain reference (the
lower readings).  Each line also gives `residual_gap_upto`, the residual
gap over the first 1, 2, ... `UPTO` cycles, to show where the rounding
floor begins.
`--control-seeds`: the control on each seed, the plain reference computed
in the next lower precision than the configuration's (float32 for
float64, bfloat16 for float32) put in the program's place (the upper
readings).  One JSON line per seed and kind, then the largest program
reading and the smallest control reading of each number.  Runs on the
CUDA device (`--device cpu` for the tests); the benchmark's runs do not
run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from portbench import harness, traffic as traffic_gen  # noqa: E402

LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}
UPTO = 8


def readings(bench, workload, seeds, control_seeds, device, out=print):
    cell = bench.cell(workload)
    cfg, cfg_dir = bench.config(cell["config"])
    tr = bench.traffic(cell["traffic"])
    dtype, level = harness.dtype_of(cfg["dtype"]), tr["level"]
    ref = bench.reference(cfg)
    residual_cycles = bench.workload(workload).get("residual_cycles")
    found = {"program": [], "control": []}

    def note(kind, seed, gaps, cycles, histories):
        row = {"kind": kind, "seed": seed, "solution_gap": max(gaps),
               "cycles_gap": max(cycles), "t": round(time.perf_counter() - T0, 1)}
        if residual_cycles is not None:
            upto = [[harness.residual_gap(h, h_ref, k) for h, h_ref in histories]
                    for k in range(1, UPTO + 1)]
            row["residual_gap_upto"] = [None if None in g else max(g) for g in upto]
            row["residual_gap"] = row["residual_gap_upto"][residual_cycles - 1]
        found[kind].append(row)
        out(json.dumps(row))

    system = bench.system(cfg).System(cfg, level, device, cfg_dir) if seeds else None
    for seed in seeds:
        rhs, order = traffic_gen.bank(tr, seed, dtype, device), traffic_gen.order(tr, seed)
        gaps, cycles, histories = [], [], []
        for i in traffic_gen.samples(tr, seed):
            system.load(rhs[order[i % len(order)]])
            c = system.solve()
            u = system.solution().clone()
            u_ref, c_ref, h_ref = ref.solve(cfg, rhs[order[i % len(order)]], level, dtype)
            gaps.append(harness.rel_gap(u, u_ref))
            cycles.append(abs(c - c_ref))
            histories.append((system.norms(), h_ref))
            del u, u_ref
        note("program", seed, gaps, cycles, histories)
    del system
    for seed in control_seeds:
        rhs, order = traffic_gen.bank(tr, seed, dtype, device), traffic_gen.order(tr, seed)
        gaps, cycles, histories = [], [], []
        for i in traffic_gen.samples(tr, seed):
            f = rhs[order[i % len(order)]]
            u_ref, c_ref, h_ref = ref.solve(cfg, f, level, dtype)
            u_low, c_low, h_low = ref.solve(cfg, f, level, LOWER[dtype])
            gaps.append(harness.rel_gap(u_low, u_ref))
            cycles.append(abs(c_low - c_ref))
            histories.append((h_low, h_ref))
            del u_ref, u_low
        note("control", seed, gaps, cycles, histories)
    summary = {"workload": workload}
    for kind, pick in (("program", max), ("control", min)):
        for k in ("solution_gap", "cycles_gap", "residual_gap"):
            values = [r[k] for r in found[kind] if r.get(k) is not None]
            if values:
                summary[f"{kind}_{k}"] = pick(values)
    out(json.dumps(summary))
    return found, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    lines = []

    def out(line):
        print(line, flush=True)
        lines.append(line)

    readings(harness.Bench(ROOT), args.workload, args.seeds, args.control_seeds, args.device,
             out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
