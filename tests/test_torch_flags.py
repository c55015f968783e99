"""Flag honesty of the port: every Knowledge flag that a module of the JAX
package reads is read by a module of the port too, or stands on the
short list below, with the reason.

A module reads a flag where its code (not a comment or docstring) names
it: an attribute access `k.<flag>`, or the flag's name as a string (a
`getattr`).  The Knowledge modules themselves (declaration and
update()'s constraints) do not count."""

import ast
import dataclasses
import functools
import pathlib

import pytest

from exastencils_tpu.config.knowledge import Knowledge as JaxKnowledge

from exastencils_tpu_torch.config.knowledge import Knowledge

REPO = pathlib.Path(__file__).resolve().parent.parent

# Flags the JAX package reads and the port does not (none since the
# sharded DSL reads `tpu_mesh_axis_names`, parallel/dslsharding.py).
NOT_READ_UNTIL_PARALLEL = frozenset()
# Read by the port's sharded backend since it was ported; each changes it
# (test_sharded_backend_reads_the_flag).
SHARDED_FLAGS = ("comm_ghostWidth", "tpu_coarse_replicate_threshold",
                 "comm_haloAggregationFactor", "tpu_overlap_halo")


@functools.cache
def flags_read(package: str) -> frozenset:
    """Flag names that the code of `package` names, outside config/knowledge.py."""
    names = {f.name for f in dataclasses.fields(JaxKnowledge)}
    seen = set()
    root = REPO / package
    for path in root.rglob("*.py"):
        if path.relative_to(root).as_posix() == "config/knowledge.py":
            continue
        tree = ast.parse(path.read_text(), str(path))
        docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                      if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                                           ast.AsyncFunctionDef))
                      and node.body and isinstance(node.body[0], ast.Expr)
                      and isinstance(node.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                seen.add(node.attr)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docstrings:
                seen.add(node.value)
    return frozenset(seen & names)


def test_every_flag_the_jax_package_reads_is_read_by_the_port():
    unread = flags_read("exastencils_tpu") - flags_read("exastencils_tpu_torch")
    assert unread == NOT_READ_UNTIL_PARALLEL, (
        f"read by the JAX package, not by the port: {sorted(unread - NOT_READ_UNTIL_PARALLEL)}; "
        f"listed but read now: {sorted(NOT_READ_UNTIL_PARALLEL - unread)}")


@pytest.mark.parametrize("names", [None, ("px", "py", "pz")])
def test_mesh_axis_names_flag_names_the_mesh_axes(names):
    """`tpu_mesh_axis_names` names the axes of the sharded DSL's mesh (and
    of mesh_from_knowledge's), as the JAX package's build_dsl_mesh names
    its mesh; by default ("bx", "by", "bz")."""
    from exastencils_tpu_torch.parallel.dslsharding import build_dsl_mesh

    flags = {} if names is None else {"tpu_mesh_axis_names": names}
    k = Knowledge(dimensionality=2, tpu_mesh_shape=(2, 2), **flags).update()
    mesh = build_dsl_mesh(k, 2, world=4)
    assert mesh.shape == (2, 2)
    assert mesh.axis_names == (names or ("bx", "by", "bz"))[:2]
    assert "tpu_mesh_axis_names" in flags_read("exastencils_tpu_torch")


def _sharded_solver(**flags):
    """A 2D Poisson solver on a 2x2 mesh's first fragment (building it does
    not communicate, so no process group is needed)."""
    from exastencils_tpu_torch.models.poisson import PoissonMGSolver
    from exastencils_tpu_torch.parallel.mesh import DomainMesh

    k = Knowledge(dimensionality=2, minLevel=2, maxLevel=6, **flags).update()
    return PoissonMGSolver(k, "cpu", mesh=DomainMesh((2, 2)), shard_dims=(2, 2))


# flag -> (a value that differs from the default, what it changes)
SHARDED_FLAG_EFFECTS = {
    "comm_ghostWidth": (3, lambda s: s.backend.topo.ghost),
    "tpu_coarse_replicate_threshold": (8, lambda s: sorted(s.backend.replicated)),
    "comm_haloAggregationFactor": (
        4, lambda s: getattr(s.levels[6].smooth_n, "__qualname__", None)),
    "tpu_overlap_halo": (True, lambda s: s.levels[6].smooth.__qualname__),
}


@pytest.mark.parametrize("flag", SHARDED_FLAGS)
def test_sharded_backend_reads_the_flag(flag):
    """Each flag the sharded backend reads changes it: the ghost width,
    the replicated set, the aggregated smoother's selection, the overlap
    smoother's selection; the port's modules name it."""
    value, effect = SHARDED_FLAG_EFFECTS[flag]
    base, flagged = effect(_sharded_solver()), effect(_sharded_solver(**{flag: value}))
    assert base != flagged, (flag, base, flagged)
    assert flag in flags_read("exastencils_tpu_torch")


def test_performance_estimate_flag_is_read():
    """The flag the port once ignored (performance_printEstimation) has a
    reader: solver/synthesis.py."""
    text = (REPO / "exastencils_tpu_torch/solver/synthesis.py").read_text()
    assert "k.performance_printEstimation" in text


def test_port_knowledge_declares_the_jax_flags():
    assert [f.name for f in dataclasses.fields(Knowledge)] == \
        [f.name for f in dataclasses.fields(JaxKnowledge)]
