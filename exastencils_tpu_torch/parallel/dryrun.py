"""Multi-rank dry run: a full ExaSlang-4 program, then the sharded Python API.

Reference: exastencils_tpu/parallel/dryrun.py (`run_dryrun`, `_dryrun_dsl`
:61-137, `_dryrun_python_api` :140-182).  First half: n ranks run
examples/poisson_2d.exa4 (levels 0-5, float64, `testing_enabled`, levels
replicated below 4 points per rank) through the sharded DSL on a mesh of
`fit_to_devices([n, n], n)`; at least one field instance must be spread
over every rank, the residual must fall below 1e-4 of the first, and
rank 0's lines must equal those of a dense run of the same program digit
for digit (abs 1e-6, or rel 1e-9 for the reduction order).  Second half:
n ranks each build a 2D Poisson solver on their fragment of a float32
maxLevel 5 problem (a px x py mesh, the coarse levels replicated below 4
cells per shard), run one V-cycle and its residual norm, and rank 0 holds
the residual to a dense solve of the same problem: relative difference
<= 1e-5 (only the reduction order differs).

    python -m exastencils_tpu_torch.parallel.dryrun [--ranks N] [--cpu]

spawns N ranks (default 4) on one host; under `torchrun --nproc-per-node N
-m exastencils_tpu_torch.parallel.dryrun` each rank joins torchrun's group
instead.  Ranks run on the card unless --cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from exastencils_tpu_torch.config import Knowledge
from exastencils_tpu_torch.models.poisson import PoissonMGSolver
from exastencils_tpu_torch.parallel.dslsharding import fit_to_devices
from exastencils_tpu_torch.parallel.mesh import init_from_env, make_domain_mesh, run_ranks

REL_BOUND = 1e-5
EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "examples", "poisson_2d.exa4")


def _factor2d(n: int):
    px = int(np.floor(np.sqrt(n)))
    while n % px:
        px -= 1
    return px, n // px


def _knowledge():
    return Knowledge(dimensionality=2, minLevel=0, maxLevel=5, useDblPrecision=False,
                     tpu_compute_dtype="float32", tpu_coarse_replicate_threshold=4).update()


def _rank(device) -> dict:
    """One rank's half of the dry run: one sharded cycle and its residual
    norm (all ranks get the same), and on rank 0 the dense one."""
    n = dist.get_world_size()
    dims = _factor2d(n)
    mesh = make_domain_mesh(dims)
    solver = PoissonMGSolver(_knowledge(), device, mesh=mesh, shard_dims=dims)
    sol, rhs = solver.init_state()
    res = float(solver._res_norm(solver._cycle(sol, rhs), rhs))
    out = {"mesh": dims, "residual": res,
           "replicated": sorted(solver.backend.replicated),
           "jax_imported": sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("jax", "exastencils_tpu"))}
    if dist.get_rank() == 0:
        dense = PoissonMGSolver(_knowledge(), device)
        dsol, drhs = dense.init_state()
        out["dense_residual"] = float(dense._res_norm(dense._cycle(dsol, drhs), drhs))
    return out


def _check(results) -> dict:
    res = {r["residual"] for r in results}
    if len(res) != 1:
        raise RuntimeError(f"dryrun: the ranks disagree on the residual: {sorted(res)}")
    first = results[0]
    bad = sorted({m for r in results for m in r["jax_imported"]})
    if bad:
        raise RuntimeError(f"dryrun: a rank imported {bad}")
    rel = abs(first["residual"] - first["dense_residual"]) / max(abs(first["dense_residual"]),
                                                                  1e-30)
    if rel > REL_BOUND:
        raise RuntimeError(f"dryrun sharded API residual {first['residual']:.6e} deviates from "
                           f"dense {first['dense_residual']:.6e} (rel {rel:.2e} > {REL_BOUND})")
    return {**first, "rel": rel, "ranks": len(results)}


def _dsl_knowledge(shard: bool = True):
    return Knowledge(dimensionality=2, minLevel=0, maxLevel=5, testing_enabled=True,
                     tpu_coarse_replicate_threshold=4, tpu_shard_dsl=shard).update()


def _dsl_rank(device) -> dict:
    """One rank's DSL half: the example over the rank mesh, its lines on
    rank 0 (and those of a dense run there), the field instances spread
    over every rank."""
    from exastencils_tpu_torch.dsl.interpreter import L4Executable
    from exastencils_tpu_torch.dsl.parser import parse_l4

    n = dist.get_world_size()
    shape = fit_to_devices([n, n], n)
    k = _dsl_knowledge()
    prog = parse_l4(EXAMPLE)
    lines = []
    ex = L4Executable(prog, k, device=device, out=lines.append,
                      mesh=make_domain_mesh(shape, tuple(k.tpu_mesh_axis_names[:2])))
    spread = sum(1 for info in ex.fields.values() for lvl in info.levels
                 if all(s or p == 1 for s, p in zip(ex._field_window(info.name, lvl).sharded,
                                                    shape)))
    ex.run()
    out = {"mesh": tuple(shape), "lines": lines, "sharded_instances": spread,
           "exchanges": ex.frag.stats.calls,
           "jax_imported": sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("jax", "exastencils_tpu"))}
    if dist.get_rank() == 0:
        dense = []
        L4Executable(prog, _dsl_knowledge(shard=False), device=device, out=dense.append).run()
        out["dense_lines"] = dense
    return out


def _line_ok(a: str, b: str) -> bool:
    """The reference's abs 1e-6, or rel 1e-9 for the reduction order."""
    if a == b:
        return True
    try:
        fa, fb = float(a), float(b)
    except ValueError:
        return False
    return abs(fa - fb) <= 1e-6 or abs(fa - fb) <= 1e-9 * max(abs(fa), abs(fb))


def _check_dsl(results) -> dict:
    first = results[0]
    bad = sorted({m for r in results for m in r["jax_imported"]})
    if bad:
        raise RuntimeError(f"dryrun: a rank imported {bad}")
    if first["sharded_instances"] == 0:
        raise RuntimeError("dryrun: no field distributed over the full mesh")
    lines, dense = first["lines"], first["dense_lines"]
    res = [float(x) for x in lines[:-1]]
    if not (res and res[-1] < 1e-4 * res[0]):
        raise RuntimeError(f"dryrun DSL solve did not converge: {lines}")
    if len(lines) != len(dense) or not all(map(_line_ok, lines, dense)):
        i = next((i for i, (a, b) in enumerate(zip(lines, dense)) if not _line_ok(a, b)),
                 min(len(lines), len(dense)))
        raise RuntimeError(f"dryrun DSL sharded/dense residual mismatch at line {i}: "
                           f"sharded={lines[i:i + 1]} dense={dense[i:i + 1]}")
    return {"mesh": first["mesh"], "ranks": len(results), "lines": lines,
            "sharded_instances": first["sharded_instances"], "res_first": res[0],
            "res_last": res[-1], "cycles": lines[-1], "exchanges": first["exchanges"]}


def _dsl_message(out: dict) -> str:
    return (f"dryrun DSL: {os.path.relpath(EXAMPLE)} on mesh {'x'.join(map(str, out['mesh']))}, "
            f"levels 0..5, {out['sharded_instances']} sharded field instances, residual "
            f"{out['res_first']:.3e} -> {out['res_last']:.3e} in {out['cycles']} V-cycles, "
            "digit-equal to the dense run")


def run_dryrun(n_ranks: int, device="cuda") -> dict:
    """Both halves over `n_ranks` spawned ranks on `device`, the DSL half
    first; returns rank 0's summary of the Python-API half (mesh,
    residual, dense residual, rel) with the DSL half's under "dsl", after
    the checks, raising if one fails."""
    dsl = _check_dsl(run_ranks(_dsl_rank, n_ranks, device=device))
    print(_dsl_message(dsl))
    out = _check(run_ranks(_rank, n_ranks, device=device))
    print(f"dryrun sharded API: mesh {out['mesh'][0]}x{out['mesh'][1]}, {out['ranks']} ranks, "
          f"levels 0..5 (replicated {out['replicated']}), residual after 1 cycle = "
          f"{out['residual']:.3e} (dense parity rel {out['rel']:.1e})")
    return {**out, "dsl": dsl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # started by torchrun
        dev = init_from_env(device)
        try:
            dsl = [None] * dist.get_world_size()
            dist.all_gather_object(dsl, _dsl_rank(dev))
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, _rank(dev))
        finally:
            dist.destroy_process_group()
        if int(os.environ["RANK"]) == 0:
            print(_dsl_message(_check_dsl(dsl)))
            summary = _check(gathered)
            print(f"dryrun sharded API: mesh {summary['mesh']}, residual "
                  f"{summary['residual']:.3e} (dense parity rel {summary['rel']:.1e})")
        return 0
    run_dryrun(args.ranks, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
