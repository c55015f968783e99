"""Generated solvers through the port's L4 executor, against the JAX
package, and the port's transfer builders against the JAX builders.

`generate solver` programs (L2 + L3, each lowered by its package's own
front end, from the same source and Knowledge keywords)
with each coarse-grid solver template (CG, BiCGStab, CR, MinRes) and the
coloring-None Gauss-Seidel program (a sequential loop, the anti-diagonal
wavefront) must print the JAX package's lines in float64 on the CPU."""

import numpy as np
import pytest
import torch

from exastencils_tpu.config import Knowledge as JaxKnowledge
from exastencils_tpu.core import stencil as jst
from exastencils_tpu.dsl import l2 as jax_l2
from exastencils_tpu.dsl import l3 as jax_l3
from exastencils_tpu.dsl.interpreter import L4Executable as JaxL4
from exastencils_tpu.solver.synthesis import default_transfer_ops as jax_default_transfer_ops

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.core import stencil as tst
from exastencils_tpu_torch.dsl import l2, l3
from exastencils_tpu_torch.dsl import nodes as N
from exastencils_tpu_torch.dsl.interpreter import Frame, L4Executable
from exastencils_tpu_torch.solver.synthesis import default_transfer_ops

from test_dsl_upper_layers import POISSON_L2

torch.set_num_threads(1)


PORT_FRONT, JAX_FRONT = (Knowledge, l2, l3), (JaxKnowledge, jax_l2, jax_l3)


def generated(src3, min_level, max_level, front=PORT_FRONT):
    """(L4 program, Knowledge) of POISSON_L2 + `src3`, built by the port's
    front end or, with front=JAX_FRONT, the JAX package's."""
    cls, m2, m3 = front
    k = cls(dimensionality=2, minLevel=min_level, maxLevel=max_level,
            testing_enabled=True).update()
    return m3.lower_l3(m2.parse_l2(POISSON_L2).merge(m3.parse_l3(src3)), k), k


def both_lines(src3, min_level, max_level):
    out = []
    for front, make in ((JAX_FRONT, lambda p, k, o: JaxL4(p, k, out=o)),
                        (PORT_FRONT, lambda p, k, o: L4Executable(p, k, device="cpu", out=o))):
        prog, k = generated(src3, min_level, max_level, front)
        lines = []
        make(prog, k, lines.append).run()
        out.append(lines)
    return out


@pytest.mark.parametrize("cgs", ["CG", "BiCGStab", "CR", "MinRes"])
def test_generated_solver_cgs_prints_the_jax_lines(cgs):
    src3 = (
        "generate solver for Solution in SolEq with {\n"
        " solver_targetResReduction = 1e-8\n"
        " solver_maxNumIts = 20\n"
        ' solver_smoother_coloring = "red-black"\n'
        " solver_smoother_damping = 0.8\n"
        f' solver_cgs = "{cgs}"\n'
        " solver_cgs_maxNumIts = 64\n"
        "}"
    )
    want, got = both_lines(src3, 2, 4)
    assert got == want
    vals = [float(v) for v in got]
    assert vals[-1] <= 1e-8 * vals[0]


def test_gauss_seidel_program_prints_the_jax_lines():
    want, got = both_lines("generate solver for Solution in SolEq with { solver_maxNumIts = 3 }", 1, 4)
    assert got == want and len(got) == 4


def test_sequential_loop_is_lexicographic_gauss_seidel():
    """One coloring-None smoother loop on a random 5x5 state equals a
    numpy lexicographic Gauss-Seidel sweep over the interior."""
    prog, k = generated("generate solver for Solution in SolEq with { solver_maxNumIts = 1 }", 1, 2)
    ex = L4Executable(prog, k, device="cpu", out=lambda s: None)
    rng = np.random.RandomState(0)
    u0, rhs = rng.rand(5, 5), rng.rand(5, 5)
    ex.set_field("Solution", 2, torch.from_numpy(u0.copy()))
    ex.set_field("RHS", 2, torch.from_numpy(rhs))
    seq = []

    def find(stmts):
        for s in stmts:
            if isinstance(s, N.RepeatTimes):
                find(s.body)
            if isinstance(s, N.LoopOverField) and s.sequentially:
                seq.append(s)

    find(ex.functions[("gen_mgCycle", 2)].body)
    assert seq
    ex.exec_stmt(seq[0], Frame({}, 2))
    got = ex.get_field("Solution", 2).numpy()
    h = 1.0 / 4
    c0, cn = 4.0 / h ** 2, -1.0 / h ** 2
    u = u0.copy()
    for i in range(1, 4):
        for j in range(1, 4):
            nb = u[i - 1, j] + u[i + 1, j] + u[i, j - 1] + u[i, j + 1]
            u[i, j] = (rhs[i, j] - cn * nb) / c0
    np.testing.assert_allclose(got, u, rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------------
# transfer builders (core/stencil.py, solver/synthesis.default_transfer_ops)
# ----------------------------------------------------------------------

BUILDERS = [
    (name, (), ndim) for ndim in (2, 3) for name in (
        "node_restriction", "node_prolongation", "node_restriction_integral",
        "cell_restriction", "cell_restriction_integral", "cell_prolongation")
] + [(f"face_{kind}", (d, integral), ndim) for ndim in (2, 3)
     for kind in ("restriction", "prolongation")
     for d in range(ndim) for integral in (False, True)]


def same_transfer(a, b):
    assert a.kind == b.kind
    assert tuple(a.lo) == tuple(b.lo)
    assert np.array_equal(np.asarray(a.weights), np.asarray(b.weights))
    assert a.kernels_1d == b.kernels_1d


@pytest.mark.parametrize("name,args,ndim", BUILDERS, ids=[f"{n}{a}-{d}d" for n, a, d in BUILDERS])
def test_transfer_builder_matches_jax(name, args, ndim):
    if args:
        d, integral = args
        same_transfer(getattr(tst, name)(d, ndim, integral), getattr(jst, name)(d, ndim, integral))
    else:
        same_transfer(getattr(tst, name)(ndim), getattr(jst, name)(ndim))


@pytest.mark.parametrize("loc", ["Node", "Cell", "Face_x", "Face_y", "Face_z"])
@pytest.mark.parametrize("interp", ["linear", "integral_linear"])
def test_default_transfer_ops_match_jax(loc, interp):
    for ours, ref in zip(default_transfer_ops(loc, 3, interp),
                         jax_default_transfer_ops(loc, 3, interp)):
        same_transfer(ours, ref)


def test_stencil_algebra_matches_jax():
    """scale/add/compose/transposed on bound stencils and the Galerkin
    product R A P with constant coefficients."""
    offs = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    coefs = (4.0, -1.0, -1.25, -0.5, -1.5)
    A_t, A_j = tst.BoundStencil("A", offs, coefs), jst.BoundStencil("A", offs, coefs)
    for op in (lambda s: s.scale(2.5), lambda s: s.add(s.transposed()),
               lambda s: s.compose(s), lambda s: s.transposed()):
        got, want = op(A_t), op(A_j)
        assert got.offsets == want.offsets
        assert np.allclose(np.asarray(got.coefs, float), np.asarray(want.coefs, float), rtol=1e-15)
    got = tst.galerkin_product(tst.node_restriction(2), A_t, tst.node_prolongation(2))
    want = jst.galerkin_product(jst.node_restriction(2), A_j, jst.node_prolongation(2))
    assert got.offsets == want.offsets
    assert np.allclose(np.asarray(got.coefs, float), np.asarray(want.coefs, float), rtol=1e-15)
