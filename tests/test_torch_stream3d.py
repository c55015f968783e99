"""The whole-leg kernels K1/K2 of the PyTorch port against the JAX package's
Pallas kernels, and their contract layer.

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
from exastencils_tpu.core.stencil import node_prolongation as j_node_prolongation
from exastencils_tpu.core.stencil import node_restriction as j_node_restriction
from exastencils_tpu.ops.pallas import make_fused_legs_3d as j_make_fused_legs_3d
from exastencils_tpu.ops.pallas.stream3d import (
    prolong_correct_smooth_fused_3d,
    smooth_res_restrict_fused_3d,
)
from exastencils_tpu.ops.transfer import build_prolong_mats, build_restrict_mats, separable_kernels

from exastencils_tpu_torch.core import field as tfield
from exastencils_tpu_torch.core.domain import unit_domain as t_unit_domain
from exastencils_tpu_torch.interop import stencil_from_jax
from exastencils_tpu_torch.ops.cuda import make_fused_legs_3d
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


def leg_inputs(level, seed):
    rng = np.random.default_rng(seed)
    n = 2 ** level + 1
    nc = (n - 1) // 2 + 1
    return (rng.standard_normal((n, n, n)), rng.standard_normal((n, n, n)),
            rng.standard_normal((nc, nc, nc)), (n,) * 3, (nc,) * 3)


@pytest.mark.parametrize("level,K", [(3, 1), (3, 3), (4, 2)])
def test_down_leg_matches_pallas(level, K):
    sol, rhs, _, fine, coarse = leg_inputs(level, 5)
    A, R = star3d(), j_node_restriction(3)
    r_mats = build_restrict_mats(R, coarse, fine, coarse)
    s_want, rc_want = smooth_res_restrict_fused_3d(
        jnp.asarray(sol), jnp.asarray(rhs), A.offsets, A.coefs, OMEGA, K,
        r_mats[1], r_mats[2], separable_kernels(R)[0], R.lo[0], coarse, interpret=True)

    sol_t = torch.from_numpy(sol.copy())
    s_got, rc_got = s3.smooth_res_restrict(
        sol_t, torch.from_numpy(rhs), stencil_from_jax(A), OMEGA, K,
        separable_kernels(R), R.lo, coarse)
    assert s_got is sol_t  # updated in place, as the donated JAX iterate
    close(s_got, s_want)
    close(rc_got, rc_want)


@pytest.mark.parametrize("level,K", [(3, 1), (3, 3), (4, 2)])
def test_up_leg_matches_pallas(level, K):
    sol, rhs, sol_c, fine, coarse = leg_inputs(level, 9)
    A, P = star3d(), j_node_prolongation(3)
    p_mats = build_prolong_mats(P, fine, coarse, fine)
    want = prolong_correct_smooth_fused_3d(
        jnp.asarray(sol), jnp.asarray(sol_c), jnp.asarray(rhs), A.offsets, A.coefs,
        OMEGA, K, p_mats[1], p_mats[2], separable_kernels(P)[0], P.lo[0], interpret=True)

    sol_t = torch.from_numpy(sol.copy())
    got = s3.prolong_correct_smooth(
        sol_t, torch.from_numpy(sol_c), torch.from_numpy(rhs), stencil_from_jax(A),
        OMEGA, K, separable_kernels(P), P.lo)
    assert got is sol_t
    close(got, want)


def test_excl_planes_are_never_written():
    sol, rhs, sol_c, _, coarse = leg_inputs(3, 3)
    A = stencil_from_jax(star3d())
    excl = (4, -1, 2, -1, -1, 6)
    R, P = j_node_restriction(3), j_node_prolongation(3)
    down, rc = s3.smooth_res_restrict_plain(
        torch.from_numpy(sol), torch.from_numpy(rhs), A, OMEGA, 2,
        separable_kernels(R), R.lo, coarse, excl)
    up = s3.prolong_correct_smooth_plain(
        torch.from_numpy(sol), torch.from_numpy(sol_c), torch.from_numpy(rhs), A,
        OMEGA, 2, separable_kernels(P), P.lo, excl)
    for out in (down, up):
        for plane in ((4, slice(None), slice(None)), (slice(None), 2, slice(None)),
                      (slice(None), slice(None), 6)):
            np.testing.assert_array_equal(out[plane].numpy(), sol[plane])
        assert not np.array_equal(out.numpy(), sol)


def test_wrappers_reject_other_devices():
    t = torch.zeros((9, 9, 9), device="meta")
    A = stencil_from_jax(star3d())
    R = j_node_restriction(3)
    with pytest.raises(ValueError, match="unsupported device"):
        s3.smooth_res_restrict(t, t, A, OMEGA, 1, separable_kernels(R), R.lo, (5, 5, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        s3.prolong_correct_smooth(t, t, t, A, OMEGA, 1, separable_kernels(R), R.lo)


def test_cpu_path_launches_no_kernel():
    before = (s3.smooth_res_restrict.launches, s3.prolong_correct_smooth.launches)
    sol, rhs, sol_c, _, coarse = leg_inputs(3, 1)
    A, R, P = stencil_from_jax(star3d()), j_node_restriction(3), j_node_prolongation(3)
    s3.smooth_res_restrict(torch.from_numpy(sol), torch.from_numpy(rhs), A, OMEGA, 1,
                           separable_kernels(R), R.lo, coarse)
    s3.prolong_correct_smooth(torch.from_numpy(sol), torch.from_numpy(sol_c),
                              torch.from_numpy(rhs), A, OMEGA, 1, separable_kernels(P), P.lo)
    assert (s3.smooth_res_restrict.launches, s3.prolong_correct_smooth.launches) == before


# ----------------------------------------------------------------------
# contract layer: the port selects the legs exactly where the JAX package does
# ----------------------------------------------------------------------


def _diag_stencil():
    return JBoundStencil("D", ((0, 0, 0), (1, 1, 0)), (4.0, -1.0))


CASES = {
    "default": dict(),
    "non_star": dict(A=_diag_stencil()),
    "nz_below_5": dict(fine=(4, 9, 9), coarse=(3, 5, 5)),
    "level_1": dict(fine=(3, 3, 3), coarse=(2, 2, 2)),
    "n_pre_0": dict(n_pre=0),
    "n_post_0": dict(n_post=0),
    "jacobi": dict(num_colors=0),
    "neumann": dict(bc="neumann"),
    "wide_z_restriction": dict(R_lo=-2, R_kernel=(0.1, 0.2, 0.4, 0.2, 0.1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_leg_selection_matches_jax(case):
    c = {"A": star3d(), "fine": (9, 9, 9), "coarse": (5, 5, 5), "n_pre": 3,
         "n_post": 3, "num_colors": 2, "bc": "dirichlet", "R_lo": -1,
         "R_kernel": None, **CASES[case]}
    R, P = j_node_restriction(3), j_node_prolongation(3)
    if c["R_kernel"] is not None:
        from exastencils_tpu.core.stencil import _separable

        R = _separable("restriction", c["R_kernel"], c["R_lo"], 3)
    jbc = jfield.DirichletBC(0.0) if c["bc"] == "dirichlet" else jfield.NeumannBC(2)
    tbc = tfield.DirichletBC(0.0) if c["bc"] == "dirichlet" else tfield.NeumannBC(2)
    jf = jfield.Field("u", j_unit_domain(3), bc=jbc)
    tf = tfield.Field("u", t_unit_domain(3), bc=tbc)
    args = (c["fine"], c["coarse"])
    tail = (OMEGA, c["n_pre"], c["n_post"], c["num_colors"])
    j_down, j_up = j_make_fused_legs_3d(c["A"], jf, 3, *args, R, P, *tail)
    t_down, t_up = make_fused_legs_3d(stencil_from_jax(c["A"]), tf, 3, *args,
                                      stencil_from_jax(R), stencil_from_jax(P), *tail)
    assert (t_down is None, t_up is None) == (j_down is None, j_up is None)
    assert (t_down is None) == (case != "default")
