"""Multi-rank dry run of the sharded Python API.

Reference: exastencils_tpu/parallel/dryrun.py (`run_dryrun`,
`_dryrun_python_api` :140-182).  n ranks each build a 2D Poisson solver on
their fragment of a float32 maxLevel 5 problem (a px x py mesh, the coarse
levels replicated below 4 cells per shard), run one V-cycle and its
residual norm, and rank 0 holds the residual to a dense solve of the same
problem: relative difference <= 1e-5 (only the reduction order differs).
The reference's first half, a full ExaSlang-4 program over a device mesh
(`_dryrun_dsl`), needs the sharded DSL, which the port does not have yet:
it raises NotImplementedError here.

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
from exastencils_tpu_torch.parallel.mesh import init_from_env, make_domain_mesh, run_ranks

REL_BOUND = 1e-5


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


def _dryrun_dsl(n_ranks: int):
    raise NotImplementedError(
        "the DSL half of the dry run (an ExaSlang-4 program over a rank mesh) needs the "
        "sharded DSL: an executor on explicit fragments with halo exchange at `communicate` "
        "(the port of exastencils_tpu/parallel/dslsharding.py), the next slice of the port")


def run_dryrun(n_ranks: int, device="cuda", dsl: bool = False) -> dict:
    """The Python-API dry run over `n_ranks` spawned ranks on `device`;
    returns rank 0's summary (mesh, residual, dense residual, rel) after
    the checks, raising if one fails.  dsl=True asks for the DSL half
    first, which is not ported (NotImplementedError)."""
    if dsl:
        _dryrun_dsl(n_ranks)
    out = _check(run_ranks(_rank, n_ranks, device=device))
    print(f"dryrun sharded API: mesh {out['mesh'][0]}x{out['mesh'][1]}, {out['ranks']} ranks, "
          f"levels 0..5 (replicated {out['replicated']}), residual after 1 cycle = "
          f"{out['residual']:.3e} (dense parity rel {out['rel']:.1e})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # started by torchrun
        dev = init_from_env(device)
        try:
            out = _rank(dev)
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, out)
        finally:
            dist.destroy_process_group()
        if int(os.environ["RANK"]) == 0:
            summary = _check(gathered)
            print(f"dryrun sharded API: mesh {summary['mesh']}, residual "
                  f"{summary['residual']:.3e} (dense parity rel {summary['rel']:.1e})")
        return 0
    run_dryrun(args.ranks, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
