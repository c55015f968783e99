"""Parity of the PyTorch port's plain ops with the JAX package's, on the CPU
in float64: the same numpy inputs go through both, compared at
max|port - jax| <= 1e-12 * max|jax|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exastencils_tpu.config import Knowledge as JaxKnowledge
from exastencils_tpu.core import field as jfield
from exastencils_tpu.core.domain import unit_domain as j_unit_domain
from exastencils_tpu.core.grid import level_grids as j_level_grids
from exastencils_tpu.core.stencil import BoundStencil as JBoundStencil
from exastencils_tpu.core.stencil import node_prolongation as j_node_prolongation
from exastencils_tpu.core.stencil import node_restriction as j_node_restriction
from exastencils_tpu.models.poisson import laplace_stencil as j_laplace
from exastencils_tpu.ops import boundary as jboundary
from exastencils_tpu.ops import smoothers as jsmoothers
from exastencils_tpu.ops import stencil_apply as jstencil_apply
from exastencils_tpu.ops import transfer as jtransfer
from exastencils_tpu.solver import krylov as jkrylov

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.core import field as tfield
from exastencils_tpu_torch.core.domain import unit_domain as t_unit_domain
from exastencils_tpu_torch.core.grid import level_grids as t_level_grids
from exastencils_tpu_torch.core.stencil import node_prolongation as t_node_prolongation
from exastencils_tpu_torch.core.stencil import node_restriction as t_node_restriction
from exastencils_tpu_torch.interop import stencil_from_jax
from exastencils_tpu_torch.models.poisson import laplace_stencil as t_laplace
from exastencils_tpu_torch.ops import boundary as tboundary
from exastencils_tpu_torch.ops import smoothers as tsmoothers
from exastencils_tpu_torch.ops import stencil_apply as tstencil_apply
from exastencils_tpu_torch.ops import transfer as ttransfer
from exastencils_tpu_torch.solver import krylov as tkrylov

torch.set_num_threads(1)
RTOL = 1e-12


def close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def grids(nd, level):
    kw = dict(dimensionality=nd, minLevel=0, maxLevel=level)
    jg = j_level_grids(j_unit_domain(nd), JaxKnowledge(**kw).update(), dtype=jnp.float64)
    tg = t_level_grids(t_unit_domain(nd), Knowledge(**kw).update(), "cpu", dtype=torch.float64)
    return jg[level], tg[level]


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def field_pair(rng, shape):
    return both(rng.standard_normal(shape))


@pytest.mark.parametrize("nd,level", [(2, 4), (3, 3)])
def test_apply_stencil(nd, level):
    jg, tg = grids(nd, level)
    xj, xt = field_pair(np.random.default_rng(1), jg.shape_of("Node"))
    close(tstencil_apply.apply_stencil(t_laplace(nd).bind(tg), xt),
          jstencil_apply.apply_stencil(j_laplace(nd).bind(jg), xj))


@pytest.mark.parametrize("nd", [2, 3])
def test_restrict_prolong(nd):
    rng = np.random.default_rng(2)
    fine, coarse = (9,) * nd, (5,) * nd
    fj, ft = field_pair(rng, fine)
    cj, ct = field_pair(rng, coarse)
    close(tstencil_apply.restrict(t_node_restriction(nd), ft, coarse),
          jstencil_apply.restrict(j_node_restriction(nd), fj, coarse))
    close(tstencil_apply.prolong(t_node_prolongation(nd), ct, fine),
          jstencil_apply.prolong(j_node_prolongation(nd), cj, fine))


@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 9)])
def test_color_mask(shape):
    for color in (0, 1):
        got = tsmoothers.color_mask(shape, color, "cpu")
        want = jsmoothers.color_mask(shape, color)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _dirichlet_fields(nd):
    def jfn(*x):
        return jnp.cos(3.0 * x[0]) + sum(x[1:])

    def tfn(*x):
        return torch.cos(3.0 * x[0]) + sum(x[1:])

    return (jfield.Field("u", j_unit_domain(nd), bc=jfield.DirichletBC(jfn)),
            tfield.Field("u", t_unit_domain(nd), bc=tfield.DirichletBC(tfn)))


@pytest.mark.parametrize("bc", ["dirichlet_fn", "dirichlet_const", "neumann1", "neumann2"])
def test_bc_applier(bc):
    jg, tg = grids(3, 3)
    if bc == "dirichlet_fn":
        jf, tf = _dirichlet_fields(3)
    else:
        jbc, tbc = {
            "dirichlet_const": (jfield.DirichletBC(0.5), tfield.DirichletBC(0.5)),
            "neumann1": (jfield.NeumannBC(1), tfield.NeumannBC(1)),
            "neumann2": (jfield.NeumannBC(2), tfield.NeumannBC(2)),
        }[bc]
        jf = jfield.Field("u", j_unit_domain(3), bc=jbc)
        tf = tfield.Field("u", t_unit_domain(3), bc=tbc)
    xj, xt = field_pair(np.random.default_rng(3), jg.shape_of("Node"))
    before = xt.clone()
    close(tboundary.make_bc_applier(tf, tg)(xt), jboundary.make_bc_applier(jf, jg)(xj))
    assert torch.equal(xt, before)  # the applier works on a clone


@pytest.mark.parametrize("nd,level,iters", [(2, 4, 2), (3, 3, 3)])
def test_make_smoother(nd, level, iters):
    jg, tg = grids(nd, level)
    jf, tf = _dirichlet_fields(nd)
    shape = jg.shape_of("Node")
    rng = np.random.default_rng(4)
    sj, st = field_pair(rng, shape)
    rj, rt = field_pair(rng, shape)
    j_smooth = jsmoothers.make_smoother(
        j_laplace(nd).bind(jg), jboundary.make_bc_applier(jf, jg), omega=0.8,
        coloring=[jsmoothers.color_mask(shape, c) for c in (0, 1)])
    t_smooth = tsmoothers.make_smoother(
        t_laplace(nd).bind(tg), tboundary.make_bc_applier(tf, tg), omega=0.8,
        coloring=[tsmoothers.color_mask(shape, c, "cpu") for c in (0, 1)])
    for _ in range(iters):
        sj, st = j_smooth(sj, rj), t_smooth(st, rt)
    close(st, sj)


def test_jacobi_update_unmasked():
    jg, tg = grids(3, 3)
    rng = np.random.default_rng(5)
    sj, st = field_pair(rng, jg.shape_of("Node"))
    rj, rt = field_pair(rng, jg.shape_of("Node"))
    close(tsmoothers.jacobi_update(st, rt, t_laplace(3).bind(tg), 0.7),
          jsmoothers.jacobi_update(sj, rj, j_laplace(3).bind(jg), 0.7))


@pytest.mark.parametrize("kind", ["restriction", "prolongation"])
def test_apply_separable(kind):
    rng = np.random.default_rng(6)
    fine, coarse = (17, 9, 13), (9, 5, 7)
    if kind == "restriction":
        mats = jtransfer.build_restrict_mats(j_node_restriction(3), coarse, fine, coarse)
        tmats = ttransfer.build_restrict_mats(t_node_restriction(3), coarse, fine, coarse)
        xj, xt = field_pair(rng, fine)
    else:
        mats = jtransfer.build_prolong_mats(j_node_prolongation(3), fine, coarse, fine)
        tmats = ttransfer.build_prolong_mats(t_node_prolongation(3), fine, coarse, fine)
        xj, xt = field_pair(rng, coarse)
    for m, tm in zip(mats, tmats):
        np.testing.assert_array_equal(tm, m)
    got = ttransfer.apply_separable(tmats, xt)
    assert got.is_contiguous()
    close(got, jtransfer.apply_separable(mats, xj))


@pytest.mark.parametrize("level", [2, 3])
def test_cg(level):
    """CG on a Dirichlet-0 3D level: same iterates, same iteration count."""
    jg, tg = grids(3, level)
    shape = jg.shape_of("Node")
    jbc = jboundary.make_bc_applier(jfield.Field("u", j_unit_domain(3), bc=0.0), jg)
    tbc = tboundary.make_bc_applier(tfield.Field("u", t_unit_domain(3), bc=0.0), tg)
    jA, tA = j_laplace(3).bind(jg), t_laplace(3).bind(tg)
    rng = np.random.default_rng(7)
    rj, rt = field_pair(rng, shape)
    kw = dict(max_its=50, res_reduction=1e-8)
    want = jkrylov.cg(lambda x: jstencil_apply.apply_stencil(jA, x), jbc(jnp.zeros(shape)),
                      rj, bc_sol=jbc, bc_res=jbc, **kw)
    got = tkrylov.cg(lambda x: tstencil_apply.apply_stencil(tA, x),
                     tbc(torch.zeros(shape, dtype=torch.float64)), rt, bc_sol=tbc, bc_res=tbc, **kw)
    assert got.iterations == int(want.iterations) > 0
    close(got.sol, want.sol)
    init_res = float(np.linalg.norm(np.asarray(jbc(rj))))
    assert abs(float(got.residual) - float(want.residual)) <= RTOL * init_res


def test_cg_all_boundary_exits_at_once():
    _, tg = grids(3, 0)
    tbc = tboundary.make_bc_applier(tfield.Field("u", t_unit_domain(3), bc=0.0), tg)
    tA = t_laplace(3).bind(tg)
    rhs = torch.ones((2, 2, 2), dtype=torch.float64)
    res = tkrylov.cg(lambda x: tstencil_apply.apply_stencil(tA, x),
                     torch.zeros_like(rhs), rhs, bc_sol=tbc, bc_res=tbc)
    assert res.iterations == 0 and float(res.residual) == 0.0
    assert torch.equal(res.sol, torch.zeros_like(rhs))


def test_bound_stencil_algebra_with_array_coefs():
    """compose / transposed shift tensor coefficients (_shift_coef)."""
    rng = np.random.default_rng(8)
    shape = (6, 7, 5)
    offs = ((0, 0, 0), (1, 0, 0), (0, -1, 0), (0, 0, 1))
    cj = [rng.standard_normal(shape) for _ in offs]
    A_j = JBoundStencil("A", offs, tuple(jnp.asarray(c) for c in cj))
    B_j = JBoundStencil("B", offs[::-1], tuple(jnp.asarray(c) for c in cj))
    A_t, B_t = stencil_from_jax(A_j), stencil_from_jax(B_j)
    for got, want in ((A_t.compose(B_t), A_j.compose(B_j)), (A_t.transposed(), A_j.transposed())):
        assert got.offsets == want.offsets
        for gc, wc in zip(got.coefs, want.coefs):
            close(gc, wc)


def test_stencil_from_jax_copies():
    jg, tg = grids(3, 2)
    A = stencil_from_jax(j_laplace(3).bind(jg))
    want = t_laplace(3).bind(tg)
    assert A.offsets == want.offsets and A.coefs == want.coefs
    R = stencil_from_jax(j_node_restriction(3))
    ref = t_node_restriction(3)
    assert (R.kind, R.lo, R.kernels_1d) == (ref.kind, ref.lo, ref.kernels_1d)
    np.testing.assert_array_equal(R.weights, ref.weights)
