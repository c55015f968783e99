"""Axis-aligned domains.

Reference: exastencils_tpu/core/domain.py (copied: importing it there goes
through exastencils_tpu/core/__init__.py, which imports jax).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class AABB:
    lower: Tuple[float, ...]
    upper: Tuple[float, ...]

    @property
    def ndim(self) -> int:
        return len(self.lower)

    def width(self, dim: int) -> float:
        return self.upper[dim] - self.lower[dim]


@dataclass(frozen=True)
class Domain:
    """A named axis-aligned domain."""

    name: str
    aabb: AABB

    @property
    def ndim(self) -> int:
        return self.aabb.ndim


def unit_domain(ndim: int, name: str = "global") -> Domain:
    return Domain(name, AABB((0.0,) * ndim, (1.0,) * ndim))
