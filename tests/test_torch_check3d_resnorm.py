"""K13's route on the CPU: `make_fused_res_norm_3d` (ops/cuda), which
solver/synthesis.py asks on every dense 3D kernel level for the level's
`res_norm_fn`, and the wrapper `check3d.res_norm`'s plain twin, which the
CPU runs in place of the kernel.  The maker accepts the constant star and
the variable-coefficient star's face arrays in float32 and float64 and
declines everything else; the twin is the old `norm_fn(residual(...))`
bit for bit, so a solve prints the lines it printed before.  The kernel
itself runs on the card only (tests/test_torch_cuda.py -k res_norm).
No jax."""

import numpy as np
import pytest
import torch

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.core.domain import unit_domain
from exastencils_tpu_torch.core.field import Field
from exastencils_tpu_torch.core.grid import CELL, NODE, level_grids
from exastencils_tpu_torch.core.stencil import BoundStencil
from exastencils_tpu_torch.models.poisson import (PoissonMGSolver, laplace_stencil,
                                                  stretched_laplace_stencil,
                                                  varcoeff_laplace_stencil)
from exastencils_tpu_torch.ops.cuda import make_fused_res_norm_3d
from exastencils_tpu_torch.ops.cuda import check3d as c3
from exastencils_tpu_torch.parallel.mesh import DomainMesh


def kappa(x, y, z):
    return torch.exp(10.0 * (x - x * x) * (y - y * y) * (z - z * z))


def grid_at(level, dtype, ndim=3, **kw):
    k = Knowledge(dimensionality=ndim, minLevel=level, maxLevel=level, **kw).update()
    return level_grids(unit_domain(ndim), k, "cpu", dtype=dtype)[level]


def residual_field(ndim=3, loc=NODE, bc=0.0):
    return Field("gen_residual", unit_domain(ndim), loc, bc=bc)


OPERATORS = {"laplace": lambda: laplace_stencil(3),
             "varcoeff": lambda: varcoeff_laplace_stencil(3, kappa)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_maker_takes_both_operators(op, dtype):
    """The constant star and the face arrays of the variable-coefficient
    star, in float32 and float64: a norm function, which on the CPU runs
    the plain twin."""
    g = grid_at(4, dtype)
    A = OPERATORS[op]().bind(g)
    norm = make_fused_res_norm_3d(A, residual_field(), 4, g.shape_of(NODE), dtype)
    assert callable(norm)
    shape = g.shape_of(NODE)
    sol, rhs = torch.ones(shape, dtype=dtype), torch.zeros(shape, dtype=dtype)
    assert torch.equal(norm(sol, rhs), c3.res_norm_plain(sol, rhs, A))


def _bf16():
    g = grid_at(4, torch.bfloat16)
    return laplace_stencil(3).bind(g), residual_field(), g.shape_of(NODE), torch.bfloat16


def _bc(value):
    def case():
        g = grid_at(4, torch.float64)
        return laplace_stencil(3).bind(g), residual_field(bc=value), g.shape_of(NODE), torch.float64
    return case


def _cell():
    g = grid_at(4, torch.float64)
    return laplace_stencil(3).bind(g), residual_field(loc=CELL), g.shape_of(NODE), torch.float64


def _2d():
    g = grid_at(4, torch.float64, ndim=2)
    return laplace_stencil(2).bind(g), residual_field(ndim=2), g.shape_of(NODE), torch.float64


def _small():
    g = grid_at(1, torch.float64)  # 3^3 nodes: fewer than 5 z-planes
    return laplace_stencil(3).bind(g), residual_field(), g.shape_of(NODE), torch.float64


def _varcoeff_small():
    g = grid_at(1, torch.float64)
    return varcoeff_laplace_stencil(3, kappa).bind(g), residual_field(), g.shape_of(NODE), \
        torch.float64


def _non_star():
    g = grid_at(4, torch.float64)
    offsets = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1),
               (1, 1, 0))
    A = BoundStencil("diag", offsets, (6.5, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -0.5))
    return A, residual_field(), g.shape_of(NODE), torch.float64


def _stretched():
    g = grid_at(4, torch.float64, grid_spacingModel="linearFct", grid_isUniform=False)
    return stretched_laplace_stencil(3).bind(g), residual_field(), g.shape_of(NODE), torch.float64


def _dtype_mismatch():
    g = grid_at(4, torch.float32)
    return varcoeff_laplace_stencil(3, kappa).bind(g), residual_field(), g.shape_of(NODE), \
        torch.float64


REFUSED = {"bf16": _bf16, "dirichlet_1": _bc(1.0), "dirichlet_fn": _bc(lambda x, y, z: 0 * x),
           "no_bc": _bc(None), "cell": _cell, "2d": _2d, "small": _small,
           "varcoeff_small": _varcoeff_small, "non_star": _non_star, "stretched": _stretched,
           "face_dtype": _dtype_mismatch}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_maker_declines_outside_the_contract(case):
    """bfloat16, a residual Dirichlet value other than exactly 0 (or a
    function, or no bc), a cell field, 2D, a shape under the kernels'
    (_kernel_shape), a non-star stencil, the stretched grid's tensor
    coefficients and face arrays of another dtype: None."""
    A, field, shape, dtype = REFUSED[case]()
    assert make_fused_res_norm_3d(A, field, 4, shape, dtype) is None


def test_sharded_backend_takes_no_fused_norm():
    """On the sharded backend (a 2x2x2 mesh's first fragment; building it
    does not communicate) no level gets K13: its norm is a psum."""
    k = Knowledge(dimensionality=3, minLevel=1, maxLevel=4).update()
    solver = PoissonMGSolver(k, "cpu", mesh=DomainMesh((2, 2, 2)), shard_dims=(2, 2, 2))
    assert solver.backend.is_sharded
    assert all(lv.res_norm_fn is None for lv in solver.levels.values())


def solver_at(max_level, dtype, op, **kw):
    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=max_level,
                  useDblPrecision=dtype == torch.float64, **kw).update()
    return PoissonMGSolver(k, "cpu", **({"kappa_fn": kappa} if op == "varcoeff" else {}))


LEVELS = {"17^3": (4, {}),
          "33x17x21": (2, dict(domain_fragmentLength_x=8, domain_fragmentLength_y=4,
                               domain_fragmentLength_z=5))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("op", sorted(OPERATORS))
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_twin_is_the_old_norm_bitwise(level, op, dtype):
    """The finest level's res_norm_fn on the CPU (check3d.res_norm's twin)
    against the level's old `norm_fn(residual(...))`, the residual's
    `bc_res` included, on seeded fields: the same bits; and
    `Multigrid.res_norm` gives them."""
    max_level, kw = LEVELS[level]
    solver = solver_at(max_level, dtype, op, **kw)
    mg = solver.mg
    lv = mg.levels[max_level]
    assert lv.res_norm_fn is not None
    rng = np.random.default_rng(max_level)
    sol, rhs = (torch.from_numpy(rng.standard_normal(lv.shape)).to(dtype) for _ in range(2))
    old = lv.norm_fn(mg.residual(max_level, sol, rhs))
    assert old.dtype == dtype
    assert torch.equal(lv.res_norm_fn(sol, rhs), old)
    assert torch.equal(mg.res_norm(sol, rhs), old)


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_solve_prints_the_lines_of_the_plain_norm(op):
    """A CPU PoissonMGSolver solve (level 4, float64, to 1e-10), with the
    route (levels 2-4 have res_norm_fn) and with it removed: the same
    printed lines, the same cycles."""
    got = []
    for fused in (True, False):
        solver = solver_at(4, torch.float64, op)
        assert sorted(lvl for lvl, lv in solver.levels.items() if lv.res_norm_fn) == [2, 3, 4]
        if not fused:
            for lv in solver.levels.values():
                lv.res_norm_fn = None
        _, lines, _, _, it = solver.solve(max_its=100, target_res_reduction=1e-10)
        got.append((lines, it))
    assert got[0] == got[1]
    assert len(got[0][0]) > 10


def test_res_norm_runs_inside_the_check_span():
    """`Multigrid.res_norm` calls the level's res_norm_fn inside its
    `check` span named res_norm (the span `solve.check_ms_per_cycle`
    reads), as it does the plain ops."""
    from exastencils_tpu_torch.runtime import timers

    solver = solver_at(4, torch.float64, "laplace")
    lv = solver.levels[4]
    calls = []
    fused = lv.res_norm_fn
    lv.res_norm_fn = lambda s, r: calls.append(1) or fused(s, r)
    sol, rhs = solver.init_state()
    timers.drain()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        solver.mg.res_norm(sol, rhs)
    spans = [s for s in timers.drain() if s.kind == "check"]
    assert calls == [1]
    assert [s.name for s in spans] == ["res_norm@4"]
