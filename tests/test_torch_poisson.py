"""The port's Poisson multigrid slice as a whole against the JAX package.

Both packages get the same Knowledge and the same initial state (the JAX
solver's init_state, carried over by interop.from_jax_state) and must
print identical residual/error lines, take the same number of cycles and
converge to 1e-10.  Float64 on the CPU; with tpu_use_pallas the JAX side
runs its Pallas legs in interpret mode and the port its K1/K2 wrappers
(their plain versions on CPU tensors)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from exastencils_tpu.config import Knowledge
from exastencils_tpu.models.poisson import PoissonMGSolver as JaxPoisson

from exastencils_tpu_torch.interop import from_jax_state
from exastencils_tpu_torch.models.poisson import PoissonMGSolver

torch.set_num_threads(1)


def graft_entry_knowledge():
    """__graft_entry__.entry()'s 2D configuration, in float64."""
    return Knowledge(dimensionality=2, minLevel=0, maxLevel=5).update()


CONFIGS = {
    "3d_l4_kernels": lambda: Knowledge(dimensionality=3, minLevel=0, maxLevel=4).update(),
    "3d_l4_plain": lambda: Knowledge(dimensionality=3, minLevel=0, maxLevel=4,
                                     tpu_use_pallas=False).update(),
    "2d_graft_entry_l5": graft_entry_knowledge,
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_solve_matches_jax(name):
    js = JaxPoisson(CONFIGS[name]())
    ts = PoissonMGSolver(CONFIGS[name](), device="cpu")
    for lvl in ts.levels:
        assert (ts.levels[lvl].down_leg_fn is None) == (js.levels[lvl].down_leg_fn is None)
    if name == "3d_l4_kernels":
        assert all(ts.levels[lvl].down_leg_fn is not None for lvl in (2, 3, 4))

    s0, r0 = js.init_state()
    state = from_jax_state(np.asarray(s0), np.asarray(r0), "cpu", torch.float64)
    j_sol, j_lines, j_init, j_res, j_it = js.solve(max_its=100, target_res_reduction=1e-10)
    t_sol, t_lines, t_init, t_res, t_it = ts.solve(max_its=100, target_res_reduction=1e-10,
                                                   state=state)
    assert t_lines == j_lines
    assert t_it == j_it
    assert t_res <= 1e-10 * t_init and j_res <= 1e-10 * j_init
    assert abs(t_init - j_init) <= 1e-12 * j_init
    assert abs(t_res - j_res) <= 1e-10 * j_init
    j_sol = np.asarray(j_sol)
    assert np.abs(t_sol.numpy() - j_sol).max() <= 1e-10 * np.abs(j_sol).max()


def test_init_state_matches_jax():
    js = JaxPoisson(CONFIGS["3d_l4_kernels"]())
    ts = PoissonMGSolver(CONFIGS["3d_l4_kernels"](), device="cpu")
    for got, want in zip(ts.init_state(), js.init_state()):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_cycle_updates_iterate_in_place_with_kernels():
    ts = PoissonMGSolver(CONFIGS["3d_l4_kernels"](), device="cpu")
    sol, rhs = ts.init_state()
    assert ts._cycle(sol, rhs) is sol


def test_rejects_unsupported_device():
    with pytest.raises(ValueError, match="unsupported device"):
        PoissonMGSolver(CONFIGS["3d_l4_plain"](), device="meta")


def test_import_leaves_jax_out():
    code = ("import sys, exastencils_tpu_torch.models.poisson, exastencils_tpu_torch.interop, "
            "exastencils_tpu_torch.ops.cuda; sys.exit(int('jax' in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr or "jax was imported"
