"""The plain reference agrees with the port's own CPU paths at level 4,
and stands apart from the program."""

import ast
import json

import pytest
import torch

from benchcopy import REPO
from portbench import harness, traffic as traffic_gen

LEVEL = 4


def bench_cfg(name):
    cfg = json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
    return cfg, harness.load_file(REPO / "portbench" / "references" / f"{cfg['reference']}.py",
                                  "reference_under_test")


def rhs_bank(dtype):
    t = json.loads((REPO / "portbench" / "traffic" / "rhs4_l9.json").read_text())
    t["level"] = LEVEL
    return traffic_gen.bank(t, 2 ** 31 + 7, dtype, "cpu")


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "references").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            assert not any(m.split(".")[0].startswith("exastencils") for m in mods), (path, mods)


@pytest.mark.parametrize("slot", [0, 3])
def test_exa4_program_matches_reference_in_float64(slot):
    """The ExaSlang program (staged executor, fast path) and the reference
    on one right-hand side, float64: the same residual norms at 6 digits,
    the same cycles, iterates within 1e-12."""
    from exastencils_tpu_torch import Knowledge
    from exastencils_tpu_torch.dsl.interpreter import L4Executable
    from exastencils_tpu_torch.dsl.parser import parse_l4

    cfg, ref = bench_cfg("poisson3d_exa4")
    f = rhs_bank(torch.float64)[slot]
    k = Knowledge(dimensionality=3, minLevel=cfg["min_level"], maxLevel=LEVEL,
                  useDblPrecision=True, tpu_shard_dsl=False, tpu_dsl_fastpath=True).update()
    lines = []
    ex = L4Executable(parse_l4(str(REPO / "portbench" / "configs" / cfg["program"])), k,
                      device="cpu", out=lines.append, jit_functions=True)
    ex.get_field("F", ex.hi).copy_(f)
    ex.call_function(ex.functions[("Solve", None)], None, [])
    u, cycles, norms = ref.solve(cfg, f, LEVEL, torch.float64)
    assert cycles == int(lines[-1])
    assert [float(x) for x in lines[:-1]] == pytest.approx(norms, rel=1e-5)
    assert harness.rel_gap(ex.get_field("U", ex.hi), u) < 1e-12


def test_api_solver_matches_reference_in_float64():
    """PoissonMGSolver.solve_fused and the reference: the same cycles,
    residual ratio and iterate (with the configuration's Dirichlet data)."""
    cfg, ref = bench_cfg("poisson3d_api_f64")
    api = harness.load_file(REPO / "portbench" / "systems" / "api_solver.py", "api_under_test")
    system = api.System(cfg, LEVEL, "cpu", None)
    f = rhs_bank(torch.float64)[1]
    system.load(f)
    cycles = system.solve()
    u, ref_cycles, norms = ref.solve(cfg, f, LEVEL, torch.float64)
    assert cycles == ref_cycles == len(norms) - 1
    assert norms[-1] <= cfg["target_res_reduction"] * norms[0] < norms[-2]
    assert harness.rel_gap(system.solution(), u) < 1e-12


def test_reference_boundary_is_the_configured_dirichlet_data():
    cfg, ref = bench_cfg("poisson3d_api_f64")
    u = ref.dirichlet(cfg["dirichlet"], LEVEL, torch.float64, "cpu")
    x = ref.positions(LEVEL, torch.float64, "cpu")
    want = torch.cos(torch.pi * x[0]) - torch.sin(2 * torch.pi * x[3]) + torch.cos(3 * torch.pi * x)
    assert torch.allclose(u[0, 3, :], want, atol=1e-15)
    assert float(u[1:-1, 1:-1, 1:-1].abs().max()) == 0.0
