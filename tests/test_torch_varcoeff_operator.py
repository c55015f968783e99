"""The variable-coefficient operator of `PoissonMGSolver(..., kappa_fn=...)`
(models/poisson.varcoeff_laplace_stencil) against a second witness: the
JAX package's L4 executor, running a small ExaSlang program whose stencil
evaluates kappa at the face midpoints from `vf_nodePos` and
`vf_gridWidth` (the form of ExaSlang's variable-coefficient tests).  Both
apply A to one seeded u, random on the Dirichlet ring too, in float64 on
the CPU; the inner nodes agree to 1e-13 of the largest value, on the
finest level of 8^3 to 32^3 cells, since each level rediscretises on its
own grid.  Kappa sampled at the nodes differs from the witness at once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exastencils_tpu.config import Knowledge as JaxKnowledge
from exastencils_tpu.dsl.interpreter import L4Executable as JaxL4
from exastencils_tpu.dsl.parser import parse_l4 as jax_parse_l4

from exastencils_tpu_torch import Knowledge
from exastencils_tpu_torch.models import poisson
from exastencils_tpu_torch.models.poisson import PoissonMGSolver
from exastencils_tpu_torch.ops.stencil_apply import apply_stencil

AXES = "xyz"
KAPPA0 = 10.0


def kappa(x, y, z):
    return torch.exp(KAPPA0 * (x - x * x) * (y - y * y) * (z - z * z))


def exa_kappa(d, side):
    """kappa at the midpoint of the edge from a node to its neighbour at
    side * e_d, in ExaSlang."""
    factors = []
    for a in range(3):
        p = f"vf_nodePos_{AXES[a]}"
        if a == d:
            p = f"( {p} {'+' if side > 0 else '-'} 0.5 * vf_gridWidth_{AXES[a]} )"
        factors.append(f"( {p} - {p} * {p} )")
    return f"exp ( {KAPPA0} * {' * '.join(factors)} )"


def exa_program():
    """w = A u on the finest level, A the conservative 7-point scheme."""
    faces = [(d, s) for d in range(3) for s in (-1, 1)]
    h2 = {d: f"( vf_gridWidth_{AXES[d]} * vf_gridWidth_{AXES[d]} )" for d in range(3)}
    entries = ["  [0, 0, 0] => " + " + ".join(f"{exa_kappa(d, s)} / {h2[d]}" for d, s in faces)]
    for d, s in faces:
        off = ", ".join(str(s if a == d else 0) for a in range(3))
        entries.append(f"  [{off}] => -1.0 * {exa_kappa(d, s)} / {h2[d]}")
    return """
Domain global< [0.0, 0.0, 0.0] to [1.0, 1.0, 1.0] >
Layout NodeNoComm< Real, Node >@all {
  duplicateLayers = [1, 1, 1]
  ghostLayers     = [0, 0, 0]
}
Field u< global, NodeNoComm, 0.0 >@all
Field w< global, NodeNoComm, 0.0 >@all
Stencil A@all {
""" + "\n".join(entries) + """
}
Function Application ( ) : Unit {
  loop over w@finest {
    w@finest = A@finest * u@finest
  }
}
"""


def seeded_u(level):
    n = 2 ** level + 1
    g = torch.Generator().manual_seed(1000 + level)
    return torch.rand((n,) * 3, generator=g, dtype=torch.float64) - 0.5


def witness(level, u):
    """A u on the inner nodes by the JAX package's executor."""
    k = JaxKnowledge(dimensionality=3, minLevel=0, maxLevel=level, tpu_shard_dsl=False).update()
    ex = JaxL4(jax_parse_l4(exa_program()), k, out=lambda s: None)
    ex.set_field("u", level, jnp.asarray(u.numpy()))
    ex.run()
    return torch.from_numpy(np.array(ex.get_field("w", level)))[(slice(1, -1),) * 3]


def port(level, u):
    """A u on the inner nodes by the port's bound stencil."""
    k = Knowledge(dimensionality=3, minLevel=0, maxLevel=level, useDblPrecision=True).update()
    solver = PoissonMGSolver(k, "cpu", kappa_fn=kappa)
    return apply_stencil(solver.stencil.bind(solver.grids[level]), u)[(slice(1, -1),) * 3]


@pytest.mark.parametrize("level", [3, 4, 5])
def test_operator_equals_the_jax_dsl_witness(level):
    u = seeded_u(level)
    want = witness(level, u)
    got = port(level, u)
    assert (got - want).abs().max() <= 1e-13 * want.abs().max()


def test_kappa_at_the_nodes_differs_from_the_witness(monkeypatch):
    """The witness tells a misplaced coefficient apart: kappa sampled at
    node j in place of the midpoint j - 1/2 is off by far more than
    rounding."""

    def at_the_nodes(grid, d, kappa_fn):
        h = grid.grid_width(d)
        coords = []
        for a in range(grid.ndim):
            x = grid.node_pos_1d(a)
            if a == d:
                x = torch.cat([x, x[-1:] + h])
            coords.append(x.reshape([-1 if b == a else 1 for b in range(grid.ndim)]))
        return kappa_fn(*coords).mul_(-1.0 / h ** 2)

    monkeypatch.setattr(poisson, "face_coefficients", at_the_nodes)
    u = seeded_u(3)
    want = witness(3, u)
    assert (port(3, u) - want).abs().max() > 1e-3 * want.abs().max()
