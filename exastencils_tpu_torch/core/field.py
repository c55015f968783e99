"""Field declarations and boundary conditions.

Reference: exastencils_tpu/core/field.py.  A `Field` is a declaration; the
data are plain tensors held by the solver.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Union

from exastencils_tpu_torch.core.domain import Domain
from exastencils_tpu_torch.core.grid import NODE


class BC:
    """Base boundary condition."""


@dataclass(frozen=True)
class NoBC(BC):
    """`None` boundary treatment."""


@dataclass(frozen=True)
class DirichletBC(BC):
    """Dirichlet value: scalar or callable of the boundary coordinates."""

    value: Union[float, Callable]


@dataclass(frozen=True)
class NeumannBC(BC):
    """Zero-flux Neumann of extrapolation order 1 or 2."""

    order: int = 2


BCLike = Union[BC, float, Callable, None]


def as_bc(bc: BCLike) -> BC:
    if bc is None:
        return NoBC()
    if isinstance(bc, BC):
        return bc
    return DirichletBC(bc)


@dataclass
class Field:
    """Field declaration over a range of levels."""

    name: str
    domain: Domain
    localization: str = NODE
    bc: Union[BCLike, Dict[int, BCLike]] = None  # single or per-level

    def bc_at(self, level: int) -> BC:
        if isinstance(self.bc, dict):
            return as_bc(self.bc.get(level))
        return as_bc(self.bc)
