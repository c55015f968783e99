"""The port's W- and F-cycles, full multigrid, multi-colour smoothers,
`Smoother` coarse solve and cycle hooks against the JAX package.

As test_torch_cycles.py: same Knowledge, same initial state, the same
kernels selected per level, identical printed lines and cycle counts;
float64 on the CPU, JAX's Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cycles import build_both, kernel_modes, solve_both

torch.set_num_threads(1)

L3 = dict(dimensionality=3, minLevel=0, maxLevel=3)
CONFIGS = {
    "w_cycle": (dict(L3, mg_cycle="W"), dict()),
    "f_cycle": (dict(L3, mg_cycle="F"), dict()),
    "fmg": (dict(L3, solver_useFMG=True, solver_fmg_startLevel=2), dict()),
    "fas_w_cycle": (dict(L3, mg_cycle="W", solver_useFAS=True), dict()),
    "jacobi_f_cycle": (dict(L3, mg_cycle="F"), dict(smoother="Jac")),
    "2d_9way": (dict(dimensionality=2, minLevel=0, maxLevel=4,
                     solver_smoother_coloring="9-way"), dict()),
    "2d_4way_w_cycle": (dict(dimensionality=2, minLevel=0, maxLevel=4,
                             solver_smoother_coloring="4-way", mg_cycle="W"), dict()),
    "2d_smoother_coarse_solve": (dict(dimensionality=2, minLevel=1, maxLevel=4),
                                 dict(cgs="Smoother", cgs_max_its=4)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_solve_matches_jax(name):
    js, ts = build_both(*CONFIGS[name])
    if name.startswith("2d"):
        assert not any(any(m) for m in kernel_modes(ts).values())
    else:
        assert any(any(m) for m in kernel_modes(ts).values())
    solve_both(js, ts)


def test_3d_multi_colour_declines_smoother_and_legs():
    """A 27-way colouring runs the plain smoother; the transfers K4/K5
    still apply, as in the JAX package."""
    js, ts = build_both(dict(L3, solver_smoother_coloring="27-way"), dict())
    modes = kernel_modes(ts)
    assert modes == kernel_modes(js)
    assert all(modes[lvl] == (False, False, False, True, True) for lvl in (2, 3))


def _jax_fmg_per_level(mg, rhs, start):
    """The JAX package's fmg with each upward cycle on its own level."""
    rhs_l = {mg.max_level: rhs}
    for lvl in range(mg.max_level, start, -1):
        rhs_l[lvl - 1] = mg.levels[lvl].restrict_fn(rhs_l[lvl])
    lv0 = mg.levels[start]
    sol = lv0.bc_sol(jnp.zeros(lv0.shape, rhs.dtype))
    sol = mg.coarse_solve(sol, rhs_l[start]) if start == mg.min_level else \
        mg.cycle(sol, rhs_l[start], start)
    for lvl in range(start + 1, mg.max_level + 1):
        lv = mg.levels[lvl]
        sol = mg.cycle(lv.bc_sol(lv.prolong_fn(sol)), rhs_l[lvl], lvl)
    return sol


@pytest.mark.parametrize("start", [0, 1])
def test_fmg_from_low_start_levels(start):
    """From start levels below maxLevel - 1 the JAX fmg cycles on the
    finest level with a coarse iterate and fails; the port cycles each
    level on its own, as the JAX package's own cycle does when called per
    level."""
    js, ts = build_both(dict(dimensionality=2, minLevel=0, maxLevel=4, solver_useFMG=True,
                             solver_fmg_startLevel=start), dict())
    _, rhs = js.init_state()
    want = np.asarray(_jax_fmg_per_level(js.mg, rhs, start))
    got = ts.mg.fmg(torch.from_numpy(np.array(rhs)), start_level=start)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    _, lines, init, res, it = ts.solve()  # FMG start, then cycles
    assert res <= 1e-10 * init and it < 10


def test_cycle_hooks_match_jax():
    """`pre`/`post` modifications run on every level above the coarsest
    with (level, sol, rhs), as in the JAX cycle."""
    js, ts = build_both(dict(L3, mg_cycle="W"), dict())

    def post(level, sol, rhs):
        return (sol * 1.01 if level == 2 else sol), rhs

    seen = []

    def pre(level, sol, rhs):
        seen.append(level)
        return sol, rhs

    js.mg.modifications.update(post=post)
    ts.mg.modifications.update(post=post, pre=pre)
    solve_both(js, ts)
    assert seen[:7] == [3, 2, 1, 1, 2, 1, 1]  # one W-cycle
