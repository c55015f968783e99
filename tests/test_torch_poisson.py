"""The port's Poisson multigrid slice as a whole against the JAX package.

Both packages get a Knowledge built from the same keywords (each its own
class) and the same initial state (the JAX solver's init_state, carried
over by interop.from_jax_state) and must
print identical residual/error lines, take the same number of cycles and
converge to 1e-10.  Float64 on the CPU; with tpu_use_pallas the JAX side
runs its Pallas legs in interpret mode and the port its K1/K2 wrappers
(their plain versions on CPU tensors)."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from exastencils_tpu.config import Knowledge as JaxKnowledge
from exastencils_tpu.models.poisson import PoissonMGSolver as JaxPoisson

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.interop import from_jax_state
from exastencils_tpu_torch.models.poisson import PoissonMGSolver

torch.set_num_threads(1)


# Knowledge keywords; "2d_graft_entry_l5" is __graft_entry__.entry()'s 2D
# configuration, in float64
CONFIGS = {
    "3d_l4_kernels": dict(dimensionality=3, minLevel=0, maxLevel=4),
    "3d_l4_plain": dict(dimensionality=3, minLevel=0, maxLevel=4, tpu_use_pallas=False),
    "2d_graft_entry_l5": dict(dimensionality=2, minLevel=0, maxLevel=5),
}


def both_solvers(name):
    """The JAX solver on the JAX Knowledge, the port's on its own."""
    return (JaxPoisson(JaxKnowledge(**CONFIGS[name]).update()),
            PoissonMGSolver(Knowledge(**CONFIGS[name]).update(), device="cpu"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_solve_matches_jax(name):
    js, ts = both_solvers(name)
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
    js, ts = both_solvers("3d_l4_kernels")
    for got, want in zip(ts.init_state(), js.init_state()):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_cycle_updates_iterate_in_place_with_kernels():
    ts = PoissonMGSolver(Knowledge(**CONFIGS["3d_l4_kernels"]).update(), device="cpu")
    sol, rhs = ts.init_state()
    assert ts._cycle(sol, rhs) is sol


def test_rejects_unsupported_device():
    with pytest.raises(ValueError, match="unsupported device"):
        PoissonMGSolver(Knowledge(**CONFIGS["3d_l4_plain"]).update(), device="meta")


REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("module", [
    "exastencils_tpu_torch", "exastencils_tpu_torch.__main__", "exastencils_tpu_torch.dsl.driver",
    "exastencils_tpu_torch.dsl.interpreter", "exastencils_tpu_torch.runtime.dsl_profile",
    "exastencils_tpu_torch.ops.cuda", "exastencils_tpu_torch.models.poisson",
    "exastencils_tpu_torch.interop"])
def test_import_leaves_jax_out(module):
    """Importing a module of the port, in a fresh interpreter, puts neither
    jax nor the JAX package (exastencils_tpu or any of its submodules)
    into sys.modules."""
    code = ("import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'exastencils_tpu'))\n"
            "sys.exit(f'imported {bad}' if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_the_jax_package():
    """No file of the port, nor chip_smoke.py, has an import statement
    (at any depth, lazy ones included) of exastencils_tpu or its
    submodules."""
    files = sorted((REPO / "exastencils_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] == "exastencils_tpu"]
    assert not bad
