"""The sharded kernel path of the port against the JAX package: the 3D
2x2x2 maxLevel 5 solve of tests/test_sharded_pallas.py, and one rank's
sharded legs and smoother (ops/cuda make_sharded_fused_legs_3d /
make_sharded_fused_smoother_3d, their plain versions on the CPU) against
the JAX makers under shard_map, on every node of every rank's fragment,
ghosts included.

One world of 8 spawned CPU ranks (a 2x2x2 mesh, gloo) serves the file,
while this process runs the JAX dense solve with kernels (interpret mode),
which tests/test_sharded_pallas.py equates to the JAX sharded run.  This
module imports jax only inside the functions that need it: the ranks
import it to run `kernels_rank` and must import neither jax nor the JAX
package (checked in every rank)."""

import concurrent.futures
import sys

import numpy as np
import pytest
import torch

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.core.domain import unit_domain
from exastencils_tpu_torch.core.field import DirichletBC, Field
from exastencils_tpu_torch.core.stencil import BoundStencil, node_prolongation, node_restriction
from exastencils_tpu_torch.models.poisson import PoissonMGSolver
from exastencils_tpu_torch.ops.cuda import (
    make_sharded_fused_legs_3d,
    make_sharded_fused_smoother_3d,
)
from exastencils_tpu_torch.parallel.mesh import make_domain_mesh, run_ranks
from exastencils_tpu_torch.parallel.topology import ShardTopology

P = (2, 2, 2)
SOLVE = dict(dimensionality=3, minLevel=1, maxLevel=5, tpu_use_pallas=True,
             tpu_coarse_replicate_threshold=8)
MAX_ITS = 12
OMEGA = 0.8
OFFSETS = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
COEFS = (6.5, -0.9, -1.1, -0.7, -1.3, -0.95, -1.05)  # distinct: a wrong side shows
# (K, ghost): the smallest fragment (2 cells per rank and dim) at the
# smallest ghost width the legs admit for K = n_pre = n_post, and at V(3,3)'s
LEG_CASES = ((1, 4), (3, 8))
CELLS = (2, 2, 2)


def leg_inputs(K, g):
    """Seeded stacked fine sol and rhs and coarse sol (ghosts random too:
    the legs exchange their operands, the coarse sol is read as given)."""
    rng = np.random.default_rng(10 * K + g)
    loc = tuple(n + 1 + 2 * g for n in CELLS)
    cloc = tuple(n // 2 + 1 + 2 * g for n in CELLS)
    return tuple(rng.standard_normal(tuple(2 * t for t in shape))
                 for shape in (loc, loc, cloc))


def frag(stacked, coords, local):
    return stacked[tuple(slice(c * t, (c + 1) * t) for c, t in zip(coords, local))]


def kernels_rank(device, leg_inputs_by_case):
    """The 3D solve with kernels on this rank, and this rank's sharded
    legs and smoother on its fragment of the seeded inputs."""
    out = {}
    k = Knowledge(**SOLVE).update()
    solver = PoissonMGSolver(k, device, mesh=make_domain_mesh(P), shard_dims=P)
    top = solver.mg.levels[k.maxLevel]
    out["selected"] = {lvl: tuple(getattr(fn, "__qualname__", None) for fn in
                                  (lv.smooth_n, lv.down_leg_fn, lv.up_leg_fn))
                       for lvl, lv in solver.mg.levels.items()}
    out["ghost"] = solver.backend.topo.ghost
    out["replicated"] = sorted(solver.backend.replicated)
    _, out["lines"], out["r0"], out["rN"], out["it"] = solver.solve(
        max_its=MAX_ITS, target_res_reduction=1e-10)
    assert top.down_leg_fn is not None
    A = BoundStencil("A", OFFSETS, COEFS)
    field = Field("u", unit_domain(3), "Node", bc=DirichletBC(0.0))
    R, Pr = node_restriction(3), node_prolongation(3)
    mesh = make_domain_mesh(P)
    for (K, g), (sol, rhs, sol_c) in leg_inputs_by_case.items():
        topo = ShardTopology(mesh, P, mesh.axis_names, g)
        ccells = tuple(n // 2 for n in CELLS)
        down, up = make_sharded_fused_legs_3d(A, field, 1, topo, CELLS, ccells, R, Pr, OMEGA,
                                              K, K, 2)
        smooth_n = make_sharded_fused_smoother_3d(A, field, 1, topo, CELLS, OMEGA, 2)
        loc, cloc = topo.local_shape(CELLS), topo.local_shape(ccells)
        s, r = (torch.from_numpy(frag(a, mesh.coords, loc).copy()).to(device) for a in (sol, rhs))
        sc = torch.from_numpy(frag(sol_c, mesh.coords, cloc).copy()).to(device)
        d_sol, d_rc = down(s.clone(), r)
        out[(K, g)] = {"down_sol": d_sol.cpu().numpy(), "down_rc": d_rc.cpu().numpy(),
                       "up": up(s.clone(), sc, r).cpu().numpy(),
                       "smooth": smooth_n(K, s.clone(), r).cpu().numpy()}
    out["coords"] = mesh.coords
    out["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "exastencils_tpu"))
    return out


def jax_dense_with_kernels():
    from exastencils_tpu.config import Knowledge as JaxKnowledge
    from exastencils_tpu.models.poisson import PoissonMGSolver as JaxPoisson

    _, lines, r0, rN, it = JaxPoisson(JaxKnowledge(**SOLVE).update()).solve(
        max_its=MAX_ITS, target_res_reduction=1e-10)
    return lines, r0, rN, it


@pytest.fixture(scope="module")
def world():
    """The ranks' results and the JAX dense run, computed side by side
    (the JAX run in this process, the ranks in theirs)."""
    inputs = {case: leg_inputs(*case) for case in LEG_CASES}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, kernels_rank, 8, inputs, device="cpu", timeout_s=600)
        dense = jax_dense_with_kernels()
        return inputs, ranks.result(), dense


def jax_legs(K, g, sol, rhs, sol_c):
    """JAX's sharded legs and smoother under shard_map on the stacked
    inputs (interpret-mode Pallas kernels)."""
    import jax
    from exastencils_tpu.core.domain import unit_domain as jax_unit_domain
    from exastencils_tpu.core.field import DirichletBC as JaxDirichlet
    from exastencils_tpu.core.field import Field as JaxField
    from exastencils_tpu.core.stencil import BoundStencil as JaxStencil
    from exastencils_tpu.core.stencil import node_prolongation as jax_np
    from exastencils_tpu.core.stencil import node_restriction as jax_nr
    from exastencils_tpu.ops.pallas import (
        make_sharded_fused_legs_3d as jax_legs_maker,
        make_sharded_fused_smoother_3d as jax_smoother_maker,
    )
    from exastencils_tpu.parallel.mesh import make_domain_mesh as jax_mesh
    from exastencils_tpu.parallel.topology import ShardTopology as JaxTopology
    from jax.sharding import PartitionSpec

    mesh = jax_mesh(P, devices=jax.devices()[:8])
    topo = JaxTopology(mesh, P, mesh.axis_names, g)
    A = JaxStencil("A", OFFSETS, COEFS)
    field = JaxField("u", jax_unit_domain(3), "node", bc=JaxDirichlet(0.0))
    down, up = jax_legs_maker(A, field, 1, topo, CELLS, tuple(n // 2 for n in CELLS), jax_nr(3),
                              jax_np(3), OMEGA, K, K, 2, itemsize=8)
    smooth_n = jax_smoother_maker(A, field, 1, topo, CELLS, OMEGA, 2)
    spec = PartitionSpec(*mesh.axis_names)

    def mapped(fn, n_in, n_out):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                                     out_specs=(spec,) * n_out if n_out > 1 else spec,
                                     check_vma=False))

    d_sol, d_rc = mapped(down, 2, 2)(sol, rhs)
    u = mapped(up, 3, 1)(sol, sol_c, rhs)
    s = mapped(lambda x, r: smooth_n(K, x, r), 2, 1)(sol, rhs)
    return tuple(np.asarray(a) for a in (d_sol, d_rc, u, s))


def test_kernel_path_selected_and_lines_match_jax_dense_with_kernels(world):
    """tests/test_sharded_pallas.py: the finest level selects the sharded
    smoother and both sharded legs (ghost >= 8), level 4 the sharded
    smoother (its coarse level is replicated); every rank prints the JAX
    dense run's lines (kernels in interpret mode) in as many cycles, res_0
    within 1e-12 and res_N within 1e-5."""
    _, results, (d_lines, d0, dN, dit) = world
    for r in results:
        sel = r["selected"]
        assert r["ghost"] >= 8
        assert r["replicated"] == [1, 2, 3]
        assert all(fn and fn.startswith("make_sharded_fused_") for fn in sel[5])
        assert sel[4][0].startswith("make_sharded_fused_smoother_3d") and sel[4][1:] == (None, None)
        assert all(v == (None, None, None) for lvl, v in sel.items() if lvl < 4)
        assert r["lines"] == d_lines
        assert r["it"] == dit
        assert abs(r["r0"] - d0) / d0 < 1e-12
        assert abs(r["rN"] - dN) / max(dN, 1e-300) < 1e-5


@pytest.mark.parametrize("K,g", LEG_CASES)
def test_sharded_legs_and_smoother_match_jax_on_every_node(world, K, g):
    """Every rank's down leg (smoothed sol and coarse rhs), up leg and
    smoother on its whole fragment, ghosts included, within 1e-12 of the
    JAX makers' under shard_map.  JAX leaves the coarse planes that no
    grid step visits unwritten (NaN in interpret mode): those are the
    planes whose z-taps all fall outside the fine fragment, and the port
    writes zero there."""
    inputs, results, _ = world
    sol, rhs, sol_c = inputs[(K, g)]
    want = jax_legs(K, g, sol, rhs, sol_c)
    loc = tuple(n + 1 + 2 * g for n in CELLS)
    cloc = tuple(n // 2 + 1 + 2 * g for n in CELLS)
    for r in results:
        got = r[(K, g)]
        w_sol, w_rc, w_up, w_s = (frag(a, r["coords"], sh)
                                  for a, sh in zip(want, (loc, cloc, loc, loc)))
        for a, b in ((got["down_sol"], w_sol), (got["up"], w_up), (got["smooth"], w_s)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        unwritten = np.isnan(w_rc).all(axis=(1, 2))
        assert not np.isnan(w_rc[~unwritten]).any()
        taps = 2 * np.arange(cloc[0])[:, None] + (-1 - g) + np.arange(3)[None, :]
        no_tap = ((taps < 0) | (taps > loc[0] - 1)).all(axis=1)
        assert not unwritten[~no_tap].any()
        np.testing.assert_array_equal(got["down_rc"][unwritten], 0.0)
        np.testing.assert_allclose(got["down_rc"][~unwritten], w_rc[~unwritten], rtol=0,
                                   atol=1e-12)


def test_ranks_import_neither_jax_nor_the_jax_package(world):
    _, results, _ = world
    assert [r["imported"] for r in results] == [[]] * 8
