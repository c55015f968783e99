"""The fused smoother K3 and the fused transfers K4/K5 of the PyTorch port
against the JAX package's Pallas kernels, their contract makers, and the
multi-colour masks that decide the kernel mode.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in Pallas interpret mode, as tests/test_pallas_kernels.py runs
them.  Float64, held to max|port - jax| <= 1e-12 * max|jax|.  The CUDA
kernels themselves are held against the plain versions by
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exastencils_tpu.core import field as jfield
from exastencils_tpu.core.domain import unit_domain as j_unit_domain
from exastencils_tpu.core.stencil import BoundStencil as JBoundStencil
from exastencils_tpu.core.stencil import _separable
from exastencils_tpu.core.stencil import cell_prolongation as j_cell_prolongation
from exastencils_tpu.core.stencil import cell_restriction as j_cell_restriction
from exastencils_tpu.core.stencil import node_prolongation as j_node_prolongation
from exastencils_tpu.core.stencil import node_restriction as j_node_restriction
from exastencils_tpu.ops import smoothers as jsmoothers
from exastencils_tpu.ops.pallas import make_fused_smoother_3d as j_make_fused_smoother_3d
from exastencils_tpu.ops.pallas import make_fused_transfers_3d as j_make_fused_transfers_3d
from exastencils_tpu.ops.pallas.stream3d import (
    prolong_correct_fused_3d,
    rbgs_fused_3d,
    res_restrict_fused_3d,
)
from exastencils_tpu.ops.transfer import build_prolong_mats, build_restrict_mats, separable_kernels

from exastencils_tpu_torch.core import field as tfield
from exastencils_tpu_torch.core.domain import unit_domain as t_unit_domain
from exastencils_tpu_torch.interop import stencil_from_jax
from exastencils_tpu_torch.ops import smoothers as tsmoothers
from exastencils_tpu_torch.ops.cuda import make_fused_smoother_3d, make_fused_transfers_3d
from exastencils_tpu_torch.ops.cuda import stream3d as s3

torch.set_num_threads(1)
RTOL = 1e-12
OMEGA = 0.8


def star3d(h=0.1):
    offsets = [(0, 0, 0)]
    coefs = [6.0 / h**2]
    for d in range(3):
        for s in (-1, 1):
            off = [0, 0, 0]
            off[d] = s
            offsets.append(tuple(off))
            coefs.append(-1.0 / h**2)
    return JBoundStencil("L", tuple(offsets), tuple(coefs))


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * np.abs(want).max())


def fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def coarse_of(fine):
    return tuple((n - 1) // 2 + 1 for n in fine)


# ----------------------------------------------------------------------
# K3: fused smoother (the shapes of tests/test_pallas_kernels.py:59-88)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(9, 9, 9), (17, 12, 21), (8, 9, 16)])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_rbgs_fused_matches_pallas(shape, K):
    sol, rhs = fields(42, shape, shape)
    A = star3d()
    want = rbgs_fused_3d(jnp.asarray(sol), jnp.asarray(rhs), A.offsets, A.coefs, OMEGA, K,
                         interpret=True)
    sol_t = torch.from_numpy(sol.copy())
    got = s3.rbgs_fused(sol_t, torch.from_numpy(rhs), stencil_from_jax(A), OMEGA, K)
    assert got is sol_t  # updated in place, as the donated JAX iterate
    close(got, want)


@pytest.mark.parametrize("excl", [(4, -1, 2, -1, -1, 6), (1, 7, -1, 10, 3, -1)])
def test_rbgs_fused_excl_matches_pallas(excl):
    shape = (9, 12, 11)
    sol, rhs = fields(3, shape, shape)
    A = star3d()
    want = rbgs_fused_3d(jnp.asarray(sol), jnp.asarray(rhs), A.offsets, A.coefs, OMEGA, 2,
                         interpret=True, excl=jnp.asarray(excl, jnp.int32))
    got = s3.rbgs_fused(torch.from_numpy(sol.copy()), torch.from_numpy(rhs),
                        stencil_from_jax(A), OMEGA, 2, excl)
    close(got, want)
    for d, p in enumerate(excl):
        if p >= 0:
            plane = tuple(p if i == d // 2 else slice(None) for i in range(3))
            np.testing.assert_array_equal(got[plane].numpy(), sol[plane])


def test_rbgs_fused_takes_any_k_in_one_call():
    """The TPU dispatcher runs K = 9 as chunks of 8 and 1; the port as one
    call of 18 half-sweeps.  K = 0 changes nothing."""
    shape = (9, 9, 9)
    sol, rhs = fields(8, shape, shape)
    A = star3d()
    want = rbgs_fused_3d(jnp.asarray(sol), jnp.asarray(rhs), A.offsets, A.coefs, OMEGA, 9,
                         interpret=True)
    At = stencil_from_jax(A)
    close(s3.rbgs_fused(torch.from_numpy(sol.copy()), torch.from_numpy(rhs), At, OMEGA, 9), want)
    np.testing.assert_array_equal(
        s3.rbgs_fused(torch.from_numpy(sol.copy()), torch.from_numpy(rhs), At, OMEGA, 0).numpy(),
        sol)


# ----------------------------------------------------------------------
# K4 / K5: fused transfers (node and cell z-geometries)
# ----------------------------------------------------------------------

TRANSFERS = {
    "node_l3": ((9, 9, 9), j_node_restriction, j_node_prolongation),
    "node_l4": ((17, 17, 17), j_node_restriction, j_node_prolongation),
    "node_non_cubic": ((17, 9, 13), j_node_restriction, j_node_prolongation),
    "cell": ((16, 16, 16), j_cell_restriction, j_cell_prolongation),
}


def _coarse(name, fine):
    return tuple(n // 2 for n in fine) if name == "cell" else coarse_of(fine)


@pytest.mark.parametrize("name", sorted(TRANSFERS))
def test_res_restrict_matches_pallas(name):
    fine, make_r, _ = TRANSFERS[name]
    coarse = _coarse(name, fine)
    sol, rhs = fields(7, fine, fine)
    A, R = star3d(), make_r(3)
    r_mats = build_restrict_mats(R, coarse, fine, coarse)
    want = res_restrict_fused_3d(jnp.asarray(sol), jnp.asarray(rhs), A.offsets, A.coefs,
                                 r_mats[1], r_mats[2], separable_kernels(R)[0], R.lo[0],
                                 coarse, interpret=True)
    sol_t = torch.from_numpy(sol.copy())
    got = s3.res_restrict(sol_t, torch.from_numpy(rhs), stencil_from_jax(A),
                          separable_kernels(R), R.lo, coarse)
    close(got, want)
    np.testing.assert_array_equal(sol_t.numpy(), sol)  # read only


@pytest.mark.parametrize("name", sorted(TRANSFERS))
def test_prolong_correct_matches_pallas(name):
    fine, _, make_p = TRANSFERS[name]
    coarse = _coarse(name, fine)
    sol, sol_c = fields(11, fine, coarse)
    P = make_p(3)
    p_mats = build_prolong_mats(P, fine, coarse, fine)
    want = prolong_correct_fused_3d(jnp.asarray(sol), jnp.asarray(sol_c), p_mats[1], p_mats[2],
                                    separable_kernels(P)[0], P.lo[0], interpret=True)
    sol_t = torch.from_numpy(sol.copy())
    got = s3.prolong_correct(sol_t, torch.from_numpy(sol_c), separable_kernels(P), P.lo)
    assert got is sol_t
    close(got, want)


def test_fused_wrappers_reject_other_devices():
    t = torch.zeros((9, 9, 9), device="meta")
    A = stencil_from_jax(star3d())
    R = j_node_restriction(3)
    with pytest.raises(ValueError, match="unsupported device"):
        s3.rbgs_fused(t, t, A, OMEGA, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        s3.res_restrict(t, t, A, separable_kernels(R), R.lo, (5, 5, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        s3.prolong_correct(t, t, separable_kernels(R), R.lo)


def test_fused_cpu_path_launches_no_kernel():
    counters = (s3.rbgs_fused, s3.res_restrict, s3.prolong_correct)
    before = [fn.launches for fn in counters]
    sol, rhs, sol_c = fields(1, (9, 9, 9), (9, 9, 9), (5, 5, 5))
    A, R, P = stencil_from_jax(star3d()), j_node_restriction(3), j_node_prolongation(3)
    s3.rbgs_fused(torch.from_numpy(sol), torch.from_numpy(rhs), A, OMEGA, 2)
    s3.res_restrict(torch.from_numpy(sol), torch.from_numpy(rhs), A, separable_kernels(R),
                    R.lo, (5, 5, 5))
    s3.prolong_correct(torch.from_numpy(sol), torch.from_numpy(sol_c), separable_kernels(P), P.lo)
    assert [fn.launches for fn in counters] == before


# ----------------------------------------------------------------------
# contract makers: the port selects K3 and K4/K5 exactly where the JAX
# package does
# ----------------------------------------------------------------------


def _field(pkg, bc):
    if pkg is jfield:
        return jfield.Field("u", j_unit_domain(3), bc=jfield.DirichletBC(0.0) if bc == "dirichlet"
                            else jfield.NeumannBC(2))
    return tfield.Field("u", t_unit_domain(3), bc=tfield.DirichletBC(0.0) if bc == "dirichlet"
                        else tfield.NeumannBC(2))


def _color_fn(*idx):
    return sum(i % 2 for i in idx)


MAKER_CASES = {
    "default": dict(),
    "four_colour": dict(num_colors=4),
    "colour_fn": dict(color_fn=_color_fn),
    "neumann": dict(bc="neumann"),
    "non_star": dict(A=JBoundStencil("D", ((0, 0, 0), (1, 1, 0)), (4.0, -1.0))),
    "nz_below_5": dict(fine=(4, 9, 9), coarse=(3, 5, 5)),
    "wide_transfer": dict(R=_separable("restriction", (0.1, 0.2, 0.4, 0.2, 0.1), -2, 3)),
    "non_separable": dict(R="non_separable"),
}


def _non_separable_restriction():
    R = j_node_restriction(3)
    w = np.array(R.weights, dtype=np.float64)
    w[0, 0, 0] += 0.05
    return type(R)(R.kind, w, R.lo)


@pytest.mark.parametrize("case", sorted(MAKER_CASES))
def test_fused_makers_match_jax(case):
    c = {"A": star3d(), "fine": (9, 9, 9), "coarse": (5, 5, 5), "num_colors": 2,
         "color_fn": None, "bc": "dirichlet", "R": j_node_restriction(3), **MAKER_CASES[case]}
    R = _non_separable_restriction() if c["R"] == "non_separable" else c["R"]
    P = j_node_prolongation(3)
    jf, tf = _field(jfield, c["bc"]), _field(tfield, c["bc"])
    tA = stencil_from_jax(c["A"])

    j_smooth = j_make_fused_smoother_3d(c["A"], jf, 3, c["fine"], OMEGA, c["num_colors"],
                                        color_fn=c["color_fn"])
    t_smooth = make_fused_smoother_3d(tA, tf, 3, c["fine"], OMEGA, c["num_colors"],
                                      color_fn=c["color_fn"])
    assert (t_smooth is None) == (j_smooth is None)
    assert (t_smooth is None) == (case in ("four_colour", "colour_fn", "neumann", "non_star",
                                           "nz_below_5"))

    j_down, j_up = j_make_fused_transfers_3d(c["A"], jf, 3, c["fine"], c["coarse"], R, P)
    t_down, t_up = make_fused_transfers_3d(tA, tf, 3, c["fine"], c["coarse"],
                                           stencil_from_jax(R), stencil_from_jax(P))
    assert (t_down is None, t_up is None) == (j_down is None, j_up is None)
    assert (t_down is None) == (case in ("neumann", "non_star", "nz_below_5", "wide_transfer",
                                         "non_separable"))


def test_made_kernels_compute_what_the_wrappers_do():
    A, R, P = star3d(), j_node_restriction(3), j_node_prolongation(3)
    tA, tR, tP = stencil_from_jax(A), stencil_from_jax(R), stencil_from_jax(P)
    tf = _field(tfield, "dirichlet")
    sol, rhs, sol_c = (torch.from_numpy(a) for a in fields(4, (9, 9, 9), (9, 9, 9), (5, 5, 5)))
    smooth_n = make_fused_smoother_3d(tA, tf, 3, (9, 9, 9), OMEGA, 2)
    down, up = make_fused_transfers_3d(tA, tf, 3, (9, 9, 9), (5, 5, 5), tR, tP)
    rk, pk = separable_kernels(R), separable_kernels(P)
    assert torch.equal(smooth_n(2, sol.clone(), rhs), s3.rbgs_fused_plain(sol, rhs, tA, OMEGA, 2))
    assert torch.equal(down(sol, rhs), s3.res_restrict_plain(sol, rhs, tA, rk, R.lo, (5, 5, 5)))
    assert torch.equal(up(sol.clone(), sol_c), s3.prolong_correct_plain(sol, sol_c, pk, P.lo))


# ----------------------------------------------------------------------
# multi-colour masks (synthesis.py's n-way colour function)
# ----------------------------------------------------------------------


def _color_fn_nd(base):
    def fn(*idx):
        expr = 0
        for i in idx:
            expr = expr * base + (i % base)
        return expr
    return fn


@pytest.mark.parametrize("shape,num_colors", [((5, 6, 7), 4), ((5, 6, 7), 27), ((7, 8), 9),
                                              ((7, 8), 4), ((6, 5, 4), 2)])
def test_color_mask_n_way_matches_jax(shape, num_colors):
    fn = None if num_colors == 2 else _color_fn_nd(round(num_colors ** (1.0 / len(shape))))
    seen = np.zeros(shape, int)
    for color in range(num_colors):
        got = tsmoothers.color_mask(shape, color, "cpu", num_colors, color_fn=fn)
        want = np.asarray(jsmoothers.color_mask(shape, color, num_colors, color_fn=fn))
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)
        seen += want
    np.testing.assert_array_equal(seen, 1)  # every node has one colour
