"""The port's Jacobi, FAS and V(0,2) solves against the JAX package: the
paths that run the fused smoother K3 and the fused transfers K4/K5.

Both packages get a Knowledge of the same keywords (each its own class)
and the same initial state
(interop.from_jax_state) and must select the same kernels on every level,
print identical residual/error lines and take the same number of cycles.
Float64 on the CPU; the JAX side runs its Pallas kernels in interpret
mode, the port its wrappers' plain versions.  The W/F-cycle, FMG,
multi-colour and coarse-solver paths are in test_torch_cycle_kinds.py."""

import numpy as np
import pytest
import torch

from exastencils_tpu.config import Knowledge as JaxKnowledge
from exastencils_tpu.models.poisson import PoissonMGSolver as JaxPoisson

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.interop import from_jax_state
from exastencils_tpu_torch.models.poisson import PoissonMGSolver

torch.set_num_threads(1)

MODE_FIELDS = ("smooth_n", "down_leg_fn", "up_leg_fn", "res_restrict_fn", "prolong_correct_fn")


def kernel_modes(solver):
    """Per level, which kernel slots are filled."""
    return {lvl: tuple(getattr(lv, f) is not None for f in MODE_FIELDS)
            for lvl, lv in solver.levels.items()}


def build_both(knowledge_kw, model_kw):
    js = JaxPoisson(JaxKnowledge(**knowledge_kw).update(), **model_kw)
    ts = PoissonMGSolver(Knowledge(**knowledge_kw).update(), device="cpu", **model_kw)
    return js, ts


def solve_both(js, ts, max_its=100):
    """Both solves from the JAX initial state; asserts identical lines and
    cycle counts and returns (jax result, port result)."""
    assert kernel_modes(ts) == kernel_modes(js)
    s0, r0 = js.init_state()
    state = from_jax_state(np.asarray(s0), np.asarray(r0), "cpu", torch.float64)
    j = js.solve(max_its=max_its, target_res_reduction=1e-10)
    t = ts.solve(max_its=max_its, target_res_reduction=1e-10, state=state)
    assert t[1] == j[1]
    assert t[4] == j[4]
    assert t[3] <= 1e-10 * t[2]
    j_sol = np.asarray(j[0])
    assert np.abs(t[0].numpy() - j_sol).max() <= 1e-10 * np.abs(j_sol).max()
    return j, t


L4 = dict(dimensionality=3, minLevel=0, maxLevel=4)
# name: (Knowledge keys, PoissonMGSolver keys, kernel slots on levels 2..4)
CONFIGS = {
    "jacobi": (L4, dict(smoother="Jac"), (False, False, False, True, True)),
    "fas": (dict(L4, solver_useFAS=True), dict(), (True, True, True, False, False)),
    "rbgs_v02": (L4, dict(n_pre=0, n_post=2), (True, False, False, True, True)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_solve_matches_jax(name):
    knowledge_kw, model_kw, slots = CONFIGS[name]
    js, ts = build_both(knowledge_kw, model_kw)
    modes = kernel_modes(ts)
    assert all(modes[lvl] == slots for lvl in (2, 3, 4))
    assert not any(modes[0] + modes[1])  # too small for the kernels
    solve_both(js, ts)


def test_fas_coarse_cycle_gets_its_own_iterate():
    """The coarse FAS cycle smooths its iterate in place (K3); the
    correction P(u_c - R u) needs R u untouched.  One cycle must reduce
    the residual as the JAX cycle does."""
    js, ts = build_both(dict(L4, solver_useFAS=True), {})
    sol, rhs = ts.init_state()
    r0 = float(ts._res_norm(sol, rhs))
    out = ts._cycle(sol, rhs)
    r1 = float(ts._res_norm(out, rhs))
    s0, rj = js.init_state()
    want = float(js._res_norm(js._cycle(s0, rj), rj))
    assert r1 < 0.1 * r0
    assert abs(r1 - want) <= 1e-10 * r0
