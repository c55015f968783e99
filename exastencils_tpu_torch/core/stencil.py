"""Stencils, bound stencils and 2:1 inter-grid operators.

Reference: exastencils_tpu/core/stencil.py.  Coefficients are Python
scalars, tensors (variable coefficients) or callables of the LevelGrid;
only `_shift_coef` touches tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from exastencils_tpu_torch.core.grid import LevelGrid

Offset = Tuple[int, ...]
Coef = Union[float, int, torch.Tensor, Callable[[LevelGrid], object]]


def _eval_coef(coef: Coef, grid: LevelGrid):
    if callable(coef):
        return coef(grid)
    return coef


@dataclass
class Stencil:
    """An offset-form stencil, possibly level-dependent through callable
    coefficients."""

    name: str
    entries: Dict[Offset, Coef] = dc_field(default_factory=dict)

    @property
    def ndim(self) -> int:
        return len(next(iter(self.entries)))

    def add_entry(self, offset: Sequence[int], coef: Coef) -> "Stencil":
        off = tuple(int(o) for o in offset)
        if off in self.entries:
            self.entries[off] = _combine(self.entries[off], coef)
        else:
            self.entries[off] = coef
        return self

    def bind(self, grid: LevelGrid) -> "BoundStencil":
        return BoundStencil(
            self.name,
            tuple(self.entries.keys()),
            tuple(_eval_coef(c, grid) for c in self.entries.values()),
        )


def _combine(a: Coef, b: Coef) -> Coef:
    if callable(a) or callable(b):
        return lambda g, _a=a, _b=b: _eval_coef(_a, g) + _eval_coef(_b, g)
    return a + b


def _shift_coef(c, offset: Offset):
    """coef(i + offset) for tensor coefficients (zero beyond bounds);
    scalars are shift-invariant."""
    if not isinstance(c, torch.Tensor) or c.dim() == 0:
        return c
    if not any(offset):
        return c
    r = max(abs(o) for o in offset)
    xp = F.pad(c, (r, r) * c.dim())
    sl = tuple(slice(r + o, r + o + n) for o, n in zip(offset, c.shape))
    return xp[sl]


@dataclass(frozen=True)
class BoundStencil:
    """A stencil with concrete per-level coefficients (scalars or tensors
    broadcastable against the field it is applied to)."""

    name: str
    offsets: Tuple[Offset, ...]
    coefs: Tuple[object, ...]

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def radius(self) -> int:
        return max(max(abs(o) for o in off) for off in self.offsets)

    def diag(self):
        return self.coefs[self.offsets.index((0,) * self.ndim)]

    def items(self):
        return zip(self.offsets, self.coefs)

    def compose(self, other: "BoundStencil") -> "BoundStencil":
        """(A*B)[i, i+p+q] += A[p](i) * B[q](i+p); tensor coefficients of
        B are shifted by p."""
        ent: Dict[Offset, object] = {}
        for p, a in self.items():
            for q, b in other.items():
                off = tuple(x + y for x, y in zip(p, q))
                term = a * _shift_coef(b, p)
                ent[off] = ent[off] + term if off in ent else term
        return BoundStencil(
            f"({self.name}*{other.name})", tuple(ent.keys()), tuple(ent.values())
        )

    def transposed(self) -> "BoundStencil":
        """S^T[o](i) = S[-o](i+o)."""
        offs, cs = [], []
        for off, c in self.items():
            noff = tuple(-o for o in off)
            offs.append(noff)
            cs.append(_shift_coef(c, noff))
        return BoundStencil(f"{self.name}^T", tuple(offs), tuple(cs))


@dataclass(frozen=True)
class IntergridStencil:
    """A 2:1 transfer operator as a weight window.

    restriction:  coarse[i] = sum_d w[d] * fine[2*i + lo + d]
    prolongation: fine[j]  += sum over coarse c with j - 2*c - lo in window:
                  w[j - 2*c - lo] * coarse[c]

    `kernels_1d` carries the per-dim factorization of a tensor-product
    window."""

    kind: str  # "restriction" | "prolongation"
    weights: np.ndarray  # full ndim weight window
    lo: Tuple[int, ...]  # offset of window element [0,...,0]
    kernels_1d: Optional[Tuple[Tuple[float, ...], ...]] = None

    @property
    def ndim(self) -> int:
        return self.weights.ndim


def _tensor_window(kernel_1d: Sequence[float], ndim: int) -> np.ndarray:
    w = np.array(kernel_1d, dtype=np.float64)
    out = w
    for _ in range(ndim - 1):
        out = np.multiply.outer(out, w)
    return out


def _separable(kind: str, kernel_1d: Sequence[float], lo: int, ndim: int) -> IntergridStencil:
    return IntergridStencil(
        kind,
        _tensor_window(kernel_1d, ndim),
        (lo,) * ndim,
        tuple(tuple(float(v) for v in kernel_1d) for _ in range(ndim)),
    )


def node_restriction(ndim: int) -> IntergridStencil:
    """Full weighting [1/4, 1/2, 1/4]^d."""
    return _separable("restriction", [0.25, 0.5, 0.25], -1, ndim)


def node_prolongation(ndim: int) -> IntergridStencil:
    """Bi/tri-linear interpolation [1/2, 1, 1/2]^d."""
    return _separable("prolongation", [0.5, 1.0, 0.5], -1, ndim)
