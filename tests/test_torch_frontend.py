"""The port's copy of the JAX package's jax-free front end against the
original, on the CPU.

The port keeps its own `config`, DSL front end (lexer, parser, nodes,
L1-L3, solver generation, grid calls), `native` and `utils.printing`, so
that it imports nothing of exastencils_tpu.  These tests hold each copy to
its reference on the same inputs: the ASTs of the example programs and of
the inline feature programs, the L2/L3 lowering of the generated-solver
programs (compared by a field-by-field walk over the dataclasses, class
names included), the Knowledge fields after `update()`, and the native
results check and reduced-precision printing."""

import dataclasses
import pathlib

import numpy as np
import pytest

from exastencils_tpu import native as jax_native
from exastencils_tpu.config import Knowledge as JaxKnowledge
from exastencils_tpu.config import parse_config_text as jax_parse_config_text
from exastencils_tpu.dsl import l2 as jax_l2
from exastencils_tpu.dsl import l3 as jax_l3
from exastencils_tpu.dsl.parser import parse_l4 as jax_parse_l4
from exastencils_tpu.utils.printing import reduced_prec_str as jax_reduced_prec_str

from exastencils_tpu_torch import Knowledge, native
from exastencils_tpu_torch.config import parse_config_text
from exastencils_tpu_torch.dsl import l2, l3
from exastencils_tpu_torch.dsl import nodes as N
from exastencils_tpu_torch.dsl.parser import parse_l4
from exastencils_tpu_torch.utils.printing import reduced_prec_str

from test_dsl_upper_layers import POISSON_L2
from test_torch_dsl_features import HEAD, PROGRAMS

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((REPO / "examples").glob("*.exa4"))


def same_tree(got, want, path="root"):
    """Walk two ASTs (the port's and the JAX package's) field by field:
    dataclasses of the same class name with equal fields, sequences and
    dicts elementwise, everything else by ==."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got).__name__ == type(want).__name__, path
        assert dataclasses.is_dataclass(got), path
        assert type(got).__module__.startswith("exastencils_tpu_torch."), path
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names, path
        for name in names:
            same_tree(getattr(got, name), getattr(want, name), f"{path}.{name}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert type(got) is type(want) and list(got) == list(want), path
        for key in want:
            same_tree(got[key], want[key], f"{path}[{key!r}]")
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.name for p in EXAMPLES])
def test_example_ast_matches_jax(path):
    got = parse_l4(str(path))
    assert isinstance(got, N.Program)
    same_tree(got, jax_parse_l4(str(path)))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_feature_program_ast_matches_jax(tmp_path, name):
    src = tmp_path / "prog.exa4"
    src.write_text(HEAD + PROGRAMS[name])
    same_tree(parse_l4(str(src)), jax_parse_l4(str(src)))


SOLVER_L3 = {
    cgs: ("generate solver for Solution in SolEq with {\n"
          " solver_targetResReduction = 1e-8\n solver_maxNumIts = 20\n"
          ' solver_smoother_coloring = "red-black"\n solver_smoother_damping = 0.8\n'
          f' solver_cgs = "{cgs}"\n solver_cgs_maxNumIts = 64\n}}')
    for cgs in ("CG", "BiCGStab", "CR", "MinRes")
}
SOLVER_L3["GS"] = "generate solver for Solution in SolEq with { solver_maxNumIts = 3 }"


@pytest.mark.parametrize("name", sorted(SOLVER_L3))
def test_generated_solver_lowering_matches_jax(name):
    """test_torch_dsl_solvers.py's programs: POISSON_L2 merged with the
    L3 `generate solver` statement, lowered to L4 by each package."""
    kw = dict(dimensionality=2, minLevel=1, maxLevel=4, testing_enabled=True)
    got = l3.lower_l3(l2.parse_l2(POISSON_L2).merge(l3.parse_l3(SOLVER_L3[name])),
                      Knowledge(**kw).update())
    want = jax_l3.lower_l3(jax_l2.parse_l2(POISSON_L2).merge(jax_l3.parse_l3(SOLVER_L3[name])),
                           JaxKnowledge(**kw).update())
    same_tree(got, want)


KNOWLEDGE_TEXTS = {
    "default": "",
    # the CLI tests' and chip_smoke.py's knowledge file
    "cli_bench": "dimensionality = 3\nminLevel = 1\nmaxLevel = 4\ntpu_shard_dsl = false\n",
    "comments_and_flags": ("// a comment\ndimensionality = 2 // trailing\nminLevel = 0\n"
                           "maxLevel = 5\nuseDblPrecision = false\nmg_cycle = \"W\"\n"
                           "solver_smoother_coloring = \"9-way\"\nomp_enabled = true\n"),
    "fas_fmg": ("dimensionality = 3\nmaxLevel = 3\nsolver_useFAS = true\n"
                "solver_useFMG = true\nsolver_fmg_startLevel = 2\ntpu_use_pallas = false\n"),
}


def knowledge_fields(k):
    return {f.name: getattr(k, f.name) for f in dataclasses.fields(k)}


@pytest.mark.parametrize("name", sorted(KNOWLEDGE_TEXTS))
def test_knowledge_matches_jax(name):
    got, want = Knowledge(), JaxKnowledge()
    parse_config_text(KNOWLEDGE_TEXTS[name], got)
    jax_parse_config_text(KNOWLEDGE_TEXTS[name], want)
    assert knowledge_fields(got.update()) == knowledge_fields(want.update())
    assert str(got.real_dtype) == "torch." + np.dtype(want.real_dtype).name


def test_check_results_matches_jax(tmp_path):
    golden = tmp_path / "golden.results"
    golden.write_text("669.971\n103.964\n  EFFECTIVELY ZERO\n6\n")
    cases = {"same": "669.971\n103.964\n  EFFECTIVELY ZERO\n6\n",
             "within_eps": "669.9710000001\n103.964\n  EFFECTIVELY ZERO\n6\n",
             "second_line": "669.971\n103.965\n  EFFECTIVELY ZERO\n6\n",
             "short": "669.971\n",
             "leading_space": "669.971\n103.964\nEFFECTIVELY ZERO\n6\n"}
    seen = set()
    for name, text in cases.items():
        got_path = tmp_path / f"{name}.out"
        got_path.write_text(text)
        for force_py in (False, True):
            rc = native.check_results(str(got_path), str(golden), 1e-6, force_py)
            assert rc == jax_native.check_results(str(got_path), str(golden), 1e-6, force_py)
            seen.add(rc)
    missing = str(tmp_path / "missing.out")
    assert native.check_results(missing, str(golden)) == jax_native.check_results(missing, str(golden))
    assert {0, 2, -3} <= seen


@pytest.mark.parametrize("max_precision,zero_threshold", [(4, 1e-12), (6, 1e-10), (2, 1e-3)])
def test_reduced_prec_str_matches_jax(max_precision, zero_threshold):
    values = [0.0, -1.0, 1e-13, 1e-12, 3.7e-12, 4.2e-11, 9.2305e-06, 0.00320617, 1.0,
              669.971, 103.96449, 1.2345678e7, 5e-4]
    for x in values:
        assert reduced_prec_str(x, max_precision, zero_threshold) == \
            jax_reduced_prec_str(x, max_precision, zero_threshold)
