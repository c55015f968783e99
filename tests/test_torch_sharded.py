"""The port's sharded backend (exastencils_tpu_torch/parallel/backend.py)
on SPMD ranks against the JAX package: the Poisson parity of
tests/test_sharded.py, the communication flags of tests/test_overlap_agg.py,
the replicated coarse levels and the sharded ExportedSolver.

One world of 8 spawned CPU ranks over gloo serves the file: ranks 0-3 (a
2x2 mesh on a subgroup) solve the 2D maxLevel 6 float64 problem with no
flag, with `tpu_overlap_halo`, with `comm_haloAggregationFactor` 6 and
with both (factor 4); ranks 4-7 (another 2x2 subgroup) run the
ExportedSolver round trip; then all 8 solve on a 4x2 mesh.  The JAX side
runs in this process (dense, and sharded under shard_map on the
conftest's 8 virtual devices).  This module imports jax only inside the
functions that need it: the ranks import it to run `sharded_rank` and
must import neither jax nor the JAX package (checked in every rank)."""

import sys

import numpy as np
import pytest
import torch.distributed as dist

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.core.domain import unit_domain
from exastencils_tpu_torch.core.grid import level_grids
from exastencils_tpu_torch.models.poisson import PoissonMGSolver
from exastencils_tpu_torch.parallel.backend import ShardedBackend
from exastencils_tpu_torch.parallel.mesh import DomainMesh, make_domain_mesh, run_ranks

BASE = dict(dimensionality=2, minLevel=2, maxLevel=6)
MAX_ITS, EPS = 20, 1e-10
# the 2x2 runs of tests/test_overlap_agg.py: name -> Knowledge flags
FLAG_RUNS = {
    "base": {},
    "overlap": {"tpu_overlap_halo": True},
    "aggregation": {"comm_haloAggregationFactor": 6},
    "both": {"tpu_overlap_halo": True, "comm_haloAggregationFactor": 4},
}
EXPORT_EPS, EXPORT_ITS = 1e-8, 20


def export_inputs():
    """A seeded global rhs and initial iterate of the finest level."""
    rng = np.random.default_rng(7)
    n = 2 ** BASE["maxLevel"] + 1
    return rng.standard_normal((n, n)), rng.standard_normal((n, n))


def _solve(device, P, group, fused=False, **flags):
    k = Knowledge(**BASE, **flags).update()
    mesh = make_domain_mesh(P, group=group)
    solver = PoissonMGSolver(k, device, mesh=mesh, shard_dims=P)
    sol, lines, r0, rN, it = solver.solve(max_its=MAX_ITS, target_res_reduction=EPS)
    dense_sol = solver.backend.gather_global(k.maxLevel, sol).cpu().numpy()
    top = solver.mg.levels[k.maxLevel]
    out = {"lines": lines, "r0": r0, "rN": rN, "it": it, "sol": dense_sol,
           "ghost": solver.backend.topo.ghost, "smooth": top.smooth.__qualname__,
           "smooth_n": getattr(top.smooth_n, "__qualname__", None)}
    if fused:  # the device-resident loop (eager on the sharded backend)
        _, f0, fN, fit = solver.solve_fused(max_its=MAX_ITS, target_res_reduction=EPS)
        out["fused"] = (float(f0), float(fN), int(fit))
    return out


def sharded_rank(device, rhs, u0):
    """One rank's share of the file's cases, by name."""
    group_a, group_b = dist.new_group([0, 1, 2, 3]), dist.new_group([4, 5, 6, 7])
    out = {}
    if dist.get_rank() < 4:
        for name, flags in FLAG_RUNS.items():
            out[name] = _solve(device, (2, 2), group_a, **flags)
    else:
        k = Knowledge(**BASE).update()
        mesh = make_domain_mesh((2, 2), group=group_b)
        exp = PoissonMGSolver(k, device, mesh=mesh, shard_dims=(2, 2)).gen.export()
        rhs_before, u0_before = rhs.copy(), u0.copy()
        sol, it, rel = exp.solve(rhs, u0=u0, target_res_reduction=EXPORT_EPS, max_its=EXPORT_ITS)
        sol0, it0, rel0 = exp.solve(rhs, target_res_reduction=EXPORT_EPS, max_its=EXPORT_ITS)
        out["export"] = {"shape": exp.shape, "sol": sol, "it": it, "rel": rel, "sol0": sol0,
                         "it0": it0, "rel0": rel0,
                         "untouched": bool(np.array_equal(rhs, rhs_before)
                                           and np.array_equal(u0, u0_before))}
    out["4x2"] = _solve(device, (4, 2), None, fused=True)
    out["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "exastencils_tpu"))
    return out


@pytest.fixture(scope="module")
def world():
    return run_ranks(sharded_rank, 8, *export_inputs(), device="cpu", timeout_s=300)


@pytest.fixture(scope="module")
def jax_dense():
    from exastencils_tpu.config import Knowledge as JaxKnowledge
    from exastencils_tpu.models.poisson import PoissonMGSolver as JaxPoisson

    _, lines, r0, rN, it = JaxPoisson(JaxKnowledge(**BASE).update()).solve(
        max_its=MAX_ITS, target_res_reduction=EPS)
    return lines, r0, rN, it


def jax_sharded(P):
    import jax
    from exastencils_tpu.config import Knowledge as JaxKnowledge
    from exastencils_tpu.models.poisson import PoissonMGSolver as JaxPoisson
    from exastencils_tpu.parallel.mesh import make_domain_mesh as jax_mesh

    mesh = jax_mesh(P, devices=jax.devices()[:int(np.prod(P))])
    _, lines, r0, rN, it = JaxPoisson(JaxKnowledge(**BASE).update(), mesh=mesh,
                                      shard_dims=P).solve(max_its=MAX_ITS, target_res_reduction=EPS)
    return lines, r0, rN, it


@pytest.mark.parametrize("P", [(2, 2), (4, 2)])
def test_sharded_poisson_prints_the_jax_dense_lines(world, jax_dense, P):
    """tests/test_sharded.py's parity: every rank prints the JAX dense
    run's lines, res_0 within 1e-12 and res_N within 1e-6 (relative), the
    same number of cycles; and the JAX sharded run's lines."""
    runs = [r["base" if P == (2, 2) else "4x2"] for r in results_of(world, P)]
    d_lines, d0, dN, dit = jax_dense
    s_lines, _, _, sit = jax_sharded(P)
    assert len(runs) == int(np.prod(P))
    for run in runs:
        assert run["lines"] == d_lines == s_lines
        assert run["it"] == dit == sit
        assert abs(run["r0"] - d0) / d0 < 1e-12
        assert abs(run["rN"] - dN) / max(dN, 1e-300) < 1e-6


def results_of(world, P):
    return world[:4] if P == (2, 2) else world


@pytest.mark.parametrize("name", ["overlap", "aggregation", "both"])
def test_communication_flags_leave_the_solve_unchanged(world, jax_dense, name):
    """tests/test_overlap_agg.py: the overlap smoother, the aggregated
    smoother and both together print the unflagged run's lines (and the
    JAX dense ones) and give its solution bit for bit; each flag selects
    its smoother on the finest (sharded) level."""
    for r in world[:4]:
        base, run = r["base"], r[name]
        assert run["lines"] == base["lines"] == jax_dense[0]
        assert run["it"] == base["it"]
        np.testing.assert_array_equal(run["sol"], base["sol"])
        assert ("make_overlap_smoother" in run["smooth"]) == (name != "aggregation")
        assert ("make_aggregated_smoother" in (run["smooth_n"] or "")) == (name != "overlap")
        assert run["ghost"] == {"overlap": 1, "aggregation": 6, "both": 4}[name]


def test_solve_fused_takes_solve_cycles_to_its_residual(world):
    """`solve_fused` (Multigrid.solve_jit, eager on the sharded backend,
    its exit test on an all-reduced residual) stops after as many cycles
    as `solve`, at the same residuals, on every rank."""
    for r in world:
        run = r["4x2"]
        assert run["fused"] == (run["r0"], run["rN"], run["it"])


def test_every_rank_gathers_the_same_solution(world):
    for P in ((2, 2), (4, 2)):
        runs = [r["base" if P == (2, 2) else "4x2"] for r in results_of(world, P)]
        for run in runs[1:]:
            np.testing.assert_array_equal(run["sol"], runs[0]["sol"])


def test_sharded_export_round_trip_matches_dense(world):
    """The sharded ExportedSolver (global numpy in, scattered; gathered
    out) gives every rank the global solution, within 1e-12 of the dense
    port's ExportedSolver, in as many cycles; the caller's arrays are
    untouched."""
    rhs, u0 = export_inputs()
    dense = PoissonMGSolver(Knowledge(**BASE).update(), "cpu").gen.export()
    want = dense.solve(rhs, u0=u0, target_res_reduction=EXPORT_EPS, max_its=EXPORT_ITS)
    want0 = dense.solve(rhs, target_res_reduction=EXPORT_EPS, max_its=EXPORT_ITS)
    for r in world[4:]:
        got = r["export"]
        assert got["shape"] == dense.shape == rhs.shape
        assert got["untouched"]
        for sol, it, rel, (w_sol, w_it, w_rel) in ((got["sol"], got["it"], got["rel"], want),
                                                   (got["sol0"], got["it0"], got["rel0"], want0)):
            assert it == w_it
            assert abs(rel - w_rel) <= 1e-12 * max(abs(w_rel), 1e-300) + 1e-300
            np.testing.assert_allclose(sol, w_sol, rtol=0, atol=1e-12 * np.abs(w_sol).max())


# (dimensionality, maxLevel, replicate threshold, shard dims): the 2D
# parity runs, the 3D kernel case, no threshold, the dry run's, a shard
# grid of 3 that divides only some levels
REPLICATION_CASES = [
    (2, 6, 32, (2, 2)),
    (2, 6, 32, (4, 2)),
    (3, 5, 8, (2, 2, 2)),
    (3, 4, 0, (2, 2, 2)),
    (2, 5, 4, (2, 2)),
    (2, 6, 2, (3, 2)),
]


@pytest.mark.parametrize("nd,max_level,threshold,P", REPLICATION_CASES)
def test_replicated_levels_equal_jax(nd, max_level, threshold, P):
    """The levels the sharded backend replicates (the coarse-grid
    agglomeration) are the JAX package's, and so are the local shapes of
    the sharded ones.  Building a backend does not communicate, so a mesh
    object of any shape serves."""
    import jax
    from exastencils_tpu.config import Knowledge as JaxKnowledge
    from exastencils_tpu.core.domain import unit_domain as jax_unit_domain
    from exastencils_tpu.core.grid import level_grids as jax_level_grids
    from exastencils_tpu.parallel.backend import ShardedBackend as JaxSharded
    from exastencils_tpu.parallel.mesh import make_domain_mesh as jax_mesh

    kw = dict(dimensionality=nd, minLevel=0, maxLevel=max_level)
    grids = level_grids(unit_domain(nd), Knowledge(**kw).update(), "cpu")
    jgrids = jax_level_grids(jax_unit_domain(nd), JaxKnowledge(**kw).update())
    if any(c % p for c, p in zip(grids[max_level].cells, P)):
        with pytest.raises(ValueError, match="not divisible"):
            ShardedBackend(grids, DomainMesh(P), P, ghost=2, replicate_below=threshold)
        return
    got = ShardedBackend(grids, DomainMesh(P), P, ghost=2, replicate_below=threshold)
    want = JaxSharded(jgrids, jax_mesh(P, devices=jax.devices()[:int(np.prod(P))]), P, ghost=2,
                      replicate_below=threshold)
    assert got.replicated == want.replicated
    assert {lvl: h.work_shape for lvl, h in got.handles.items()} == \
        {lvl: tuple(h.work_shape) for lvl, h in want.handles.items()}


def test_ranks_import_neither_jax_nor_the_jax_package(world):
    assert [r["imported"] for r in world] == [[]] * 8
