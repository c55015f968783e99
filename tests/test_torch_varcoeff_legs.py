"""K11/K12's contract and their plain twins on the CPU: the variable-
coefficient legs (ops/cuda/stream3d.smooth_res_restrict_faces,
prolong_correct_smooth_faces) that `make_fused_legs_3d` gives a level of
`PoissonMGSolver(kappa_fn=...)`.  The bound stencil of
models/poisson.varcoeff_laplace_stencil carries its face arrays, and no
other stencil does; `face_arrays` accepts it on every level of at least 5
nodes a dimension and declines the stretched stencil, stencils put
together by hand (a centre one ulp off the face sum, face views of two
arrays), its faces in bfloat16 and a level of 3 nodes, and takes no notice
of EXA_STREAM_V1=1; the wrappers' plain twins give the plain cycle to the last bit
and the solver's printed lines are the plain path's.  Levels 3-5, float32
and float64.  The kernels themselves run on the card
(tests/test_torch_cuda.py, "K11/K12")."""

import dataclasses

import pytest
import torch

import exastencils_tpu_torch.ops.cuda as makers
from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.core.domain import unit_domain
from exastencils_tpu_torch.core.grid import NODE, level_grids
from exastencils_tpu_torch.core.stencil import BoundStencil
from exastencils_tpu_torch.models import poisson
from exastencils_tpu_torch.models.poisson import PoissonMGSolver
from exastencils_tpu_torch.ops.cuda import stream3d as s3

LEVELS = [3, 4, 5]
DTYPES = [torch.float32, torch.float64]


def kappa(x, y, z):
    return torch.exp(10.0 * (x - x * x) * (y - y * y) * (z - z * z))


def solver(level, dtype, **kw):
    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=level,
                  useDblPrecision=dtype == torch.float64).update()
    return PoissonMGSolver(k, "cpu", kappa_fn=kappa, **kw)


def finest(sol):
    """The finest level's bound stencil, shape and coarse shape."""
    lvl = max(sol.grids)
    A = sol.stencil.bind(sol.grids[lvl])
    return A, tuple(sol.grids[lvl].shape_of(NODE)), tuple(sol.grids[lvl - 1].shape_of(NODE))


def legs_of(sol, A, lvl, shape, cshape):
    return makers.make_fused_legs_3d(A, sol.solution, lvl, shape, cshape, sol.restrict_op,
                                     sol.prolong_op, sol.omega, sol.n_pre, sol.n_post, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", LEVELS)
def test_contract_accepts_the_kappa_stencil(level, dtype):
    """Every level of at least 5 nodes: the face arrays are the stencil's
    own storage (views, nothing copied), n_d + 1 long along d, and the
    solver's level gets the legs; level 1 (3 nodes) and 0 do not."""
    sol = solver(level, dtype)
    for lvl, grid in sol.grids.items():
        A = sol.stencil.bind(grid)
        n = grid.shape_of(NODE)[0]
        faces = s3.face_arrays((n,) * 3, A)
        has_legs = sol.levels[lvl].down_leg_fn is not None
        if n < 5:
            assert faces is None and not has_legs
            continue
        assert has_legs and sol.levels[lvl].up_leg_fn is not None
        by_off = dict(A.items())
        for d, f in enumerate(faces):
            assert f.dtype == dtype and f.is_contiguous()
            assert f.shape == tuple(n + (i == d) for i in range(3))
            minus = by_off[tuple(-1 if i == d else 0 for i in range(3))]
            assert f.data_ptr() == minus.data_ptr()
            assert torch.equal(f.narrow(d, 1, n), by_off[tuple(int(i == d) for i in range(3))])


def stretched(level, dtype):
    """The stretched Laplacian bound on a `linearFct` grid's `level`."""
    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=level, grid_spacingModel="linearFct",
                  grid_isUniform=False, useDblPrecision=dtype == torch.float64).update()
    grid = level_grids(unit_domain(3), k, "cpu", dtype=dtype)[level]
    return poisson.stretched_laplace_stencil(3).bind(grid)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", [3, 4])
def test_only_the_kappa_stencil_carries_face_arrays(level, dtype):
    """The bound kappa stencil carries its level's three face arrays, the
    storages of its minus and plus entries, and `face_arrays` returns
    exactly them (none for another level's shape); the constant and the
    stretched Laplacian and the kappa stencil scale()d carry none."""
    sol = solver(level, dtype)
    A, shape, cshape = finest(sol)
    by_off = dict(A.items())
    assert len(A.faces) == 3
    for d, f in enumerate(A.faces):
        for side in (-1, 1):
            entry = by_off[tuple(side if i == d else 0 for i in range(3))]
            assert entry.untyped_storage().data_ptr() == f.untyped_storage().data_ptr()
    assert s3.face_arrays(shape, A) is A.faces
    assert s3.face_arrays(cshape, A) is None
    others = (poisson.laplace_stencil(3).bind(sol.grids[level]), stretched(level, dtype),
              A.scale(0.5))
    for other in others:
        assert other.faces is None and s3.face_arrays(shape, other) is None


def declined(case, level, dtype):
    """(A, shape) of the finest level altered by `case`."""
    sol = solver(level, dtype)
    A, shape, _ = finest(sol)
    entries = [dict(A.items())[o] for o in s3.STAR_OFFSETS]
    if case == "stretched":
        A = stretched(level, dtype)
    elif case == "centre_one_ulp":
        centre = entries[0].clone()
        centre[2, 3, 1] = torch.nextafter(centre[2, 3, 1], torch.tensor(float("inf"), dtype=dtype))
        A = BoundStencil(A.name, s3.STAR_OFFSETS, (centre, *entries[1:]))
    elif case == "two_arrays":
        face = A.faces[1].clone()
        plus = poisson.plus_side(face, 1, shape[1])
        A = BoundStencil(A.name, s3.STAR_OFFSETS, (*entries[:4], plus, *entries[5:]))
    elif case == "bfloat16":
        faces = tuple(f.to(torch.bfloat16) for f in A.faces)
        sides = []
        for d, f in enumerate(faces):
            sides += [poisson.minus_side(f, d, shape[d]), poisson.plus_side(f, d, shape[d])]
        centre = sides[0] + sides[1]
        for c in sides[2:]:
            centre.add_(c)
        A = BoundStencil(A.name, s3.STAR_OFFSETS, (centre.neg_(), *sides), faces)
    elif case == "below_5_planes":
        A, shape = sol.stencil.bind(sol.grids[1]), (3, 3, 3)
    return sol, A, shape


@pytest.mark.parametrize("case", ["stretched", "centre_one_ulp", "two_arrays", "bfloat16",
                                  "below_5_planes"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", LEVELS)
def test_contract_declines(level, dtype, case):
    """The stretched stencil (1-D broadcast coefficients), a centre one ulp
    off the face sum at one node and the plus side of an axis from a copy
    of its face array (both put together by hand, so they carry no face
    arrays), the same stencil carrying its faces in bfloat16 and a level of
    3 nodes: no face arrays, and the leg maker declines."""
    sol, A, shape = declined(case, level, dtype)
    assert s3.face_arrays(shape, A) is None
    cshape = tuple((n + 1) // 2 for n in shape)
    assert legs_of(sol, A, level, shape, cshape) == (None, None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", LEVELS)
def test_contract_ignores_stream_v1(monkeypatch, level, dtype):
    """EXA_STREAM_V1=1 chooses between the constant legs' schedules only:
    under it the finest level still gives the same face arrays, and the
    maker still returns K11/K12's wrappers."""
    sol = solver(level, dtype)
    A, shape, cshape = finest(sol)
    want = s3.face_arrays(shape, A)
    monkeypatch.setenv("EXA_STREAM_V1", "1")
    got = s3.face_arrays(shape, A)
    assert [f.data_ptr() for f in got] == [f.data_ptr() for f in want]
    down, up = legs_of(sol, A, level, shape, cshape)
    assert down.__name__ == "down_faces" and up.__name__ == "up_faces"


def without_legs(mg):
    """The hierarchy with every level's legs taken away: the plain cycle."""
    return dataclasses.replace(mg, levels={
        lvl: dataclasses.replace(lv, down_leg_fn=None, up_leg_fn=None)
        for lvl, lv in mg.levels.items()})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", LEVELS)
def test_plain_twins_give_the_plain_cycle(level, dtype):
    """Two V(3,3)-cycles on seeded right-hand sides: through the legs'
    plain twins (what the CPU runs in place of K11/K12) and through the
    plain ops, bitwise equal."""
    sol = solver(level, dtype)
    assert all(sol.levels[lvl].down_leg_fn is not None for lvl in range(2, level + 1))
    plain = without_legs(sol.mg)
    x, f = sol.init_state()
    g = torch.Generator().manual_seed(level)
    f = f + torch.rand(f.shape, generator=g, dtype=torch.float64).to(dtype)
    a, b = x.clone(), x.clone()
    for _ in range(2):
        a, b = sol.mg.cycle(a, f), plain.cycle(b, f)
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level", LEVELS)
def test_solve_prints_the_lines_of_the_plain_path(monkeypatch, level, dtype):
    """The solver's printed lines, cycle count and solution are the same
    with the variable-coefficient legs (their plain twins here) and with
    their maker taken away, where every level runs the plain ops."""
    got = solver(level, dtype).solve(max_its=12, target_res_reduction=1e-10)
    monkeypatch.setattr(makers, "face_arrays", lambda *a: None)
    plain = solver(level, dtype)
    assert all(lv.down_leg_fn is None for lv in plain.levels.values())
    want = plain.solve(max_its=12, target_res_reduction=1e-10)
    assert got[1] == want[1] and len(got[1]) > 10
    assert got[4] == want[4] and torch.equal(got[0], want[0])
