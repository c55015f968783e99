"""Stencils, stencil algebra and 2:1 inter-grid operators.

Reference: exastencils_tpu/core/stencil.py.  Coefficients are Python
scalars, tensors (variable coefficients, the stencil-field case) or
callables of the LevelGrid; only `_shift_coef` touches tensors.  The
transfer builders (node, node-integral, cell, cell-integral, face) are
numpy weight windows, as in the reference.
"""

from __future__ import annotations

import itertools
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

    # --- algebra (reference IR_StencilOps.scala) ---
    def __add__(self, other: "Stencil") -> "Stencil":
        out = Stencil(f"({self.name}+{other.name})", dict(self.entries))
        for off, c in other.entries.items():
            out.add_entry(off, c)
        return out

    def __sub__(self, other: "Stencil") -> "Stencil":
        return self + other.scaled(-1.0)

    def scaled(self, s: float) -> "Stencil":
        return Stencil(
            f"({s}*{self.name})",
            {off: _scale_coef(c, s) for off, c in self.entries.items()},
        )

    def transpose(self) -> "Stencil":
        """Offset negation."""
        return Stencil(
            f"{self.name}^T", {tuple(-o for o in off): c for off, c in self.entries.items()}
        )

    def diag(self) -> Coef:
        zero = (0,) * self.ndim
        if zero not in self.entries:
            raise ValueError(f"stencil {self.name} has no center entry")
        return self.entries[zero]

    def compose(self, other: "Stencil") -> "Stencil":
        """(A*B)[o] = sum_{p+q=o} A[p] B[q] for constant coefficients."""
        out = Stencil(f"({self.name}*{other.name})")
        for (po, pc), (qo, qc) in itertools.product(self.entries.items(), other.entries.items()):
            out.add_entry(tuple(a + b for a, b in zip(po, qo)), _mul_coefs(pc, qc))
        return out

    def kron(self, other: "Stencil") -> "Stencil":
        """Dimensionality-raising tensor product."""
        out = Stencil(f"({self.name}(x){other.name})")
        for (po, pc), (qo, qc) in itertools.product(self.entries.items(), other.entries.items()):
            out.add_entry(po + qo, _mul_coefs(pc, qc))
        return out

    def bind(self, grid: LevelGrid) -> "BoundStencil":
        return BoundStencil(
            self.name,
            tuple(self.entries.keys()),
            tuple(_eval_coef(c, grid) for c in self.entries.values()),
        )

    @property
    def radius(self) -> int:
        return max(max(abs(o) for o in off) for off in self.entries)


def _scale_coef(c: Coef, s: float) -> Coef:
    if callable(c):
        return lambda g, _c=c, _s=s: _s * _eval_coef(_c, g)
    return s * c


def _combine(a: Coef, b: Coef) -> Coef:
    if callable(a) or callable(b):
        return lambda g, _a=a, _b=b: _eval_coef(_a, g) + _eval_coef(_b, g)
    return a + b


def _mul_coefs(a: Coef, b: Coef) -> Coef:
    if callable(a) or callable(b):
        return lambda g, _a=a, _b=b: _eval_coef(_a, g) * _eval_coef(_b, g)
    return a * b


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


def _mul_shifted(a, b, p: Offset):
    """A[p](i) * B[q](i+p): B's variable coefficient reads at i+p."""
    return a * _shift_coef(b, p)


@dataclass(frozen=True)
class BoundStencil:
    """A stencil with concrete per-level coefficients (scalars or tensors
    broadcastable against the field it is applied to).  `faces`: the face
    arrays whose views the coefficients are, set only by the bind of
    models/poisson.varcoeff_laplace_stencil (ops/cuda's K11/K12 read
    them); a stencil made any other way, scale() and the algebra included,
    carries none."""

    name: str
    offsets: Tuple[Offset, ...]
    coefs: Tuple[object, ...]
    faces: Optional[Tuple[torch.Tensor, ...]] = dc_field(default=None, compare=False)

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

    def scale(self, s) -> "BoundStencil":
        return BoundStencil(
            f"({s}*{self.name})", self.offsets, tuple(c * s for c in self.coefs)
        )

    def add(self, other: "BoundStencil") -> "BoundStencil":
        ent: Dict[Offset, object] = {}
        for off, c in list(self.items()) + list(other.items()):
            ent[off] = ent[off] + c if off in ent else c
        return BoundStencil(
            f"({self.name}+{other.name})", tuple(ent.keys()), tuple(ent.values())
        )

    def compose(self, other: "BoundStencil") -> "BoundStencil":
        """(A*B)[i, i+p+q] += A[p](i) * B[q](i+p); tensor coefficients of
        B are shifted by p."""
        ent: Dict[Offset, object] = {}
        for p, a in self.items():
            for q, b in other.items():
                off = tuple(x + y for x, y in zip(p, q))
                term = _mul_shifted(a, b, p)
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

    def transposed(self) -> "IntergridStencil":
        """R^T = P with the same window, and vice versa."""
        kind = "prolongation" if self.kind == "restriction" else "restriction"
        return IntergridStencil(kind, self.weights, self.lo, self.kernels_1d)

    def scaled(self, s: float) -> "IntergridStencil":
        kernels = None
        if self.kernels_1d is not None:
            kernels = (tuple(float(v) * float(s) for v in self.kernels_1d[0]),) + tuple(
                self.kernels_1d[1:]
            )
        return IntergridStencil(self.kind, self.weights * s, self.lo, kernels)


def galerkin_product(
    R: IntergridStencil, A: BoundStencil, P: IntergridStencil
) -> BoundStencil:
    """Galerkin coarse operator A_c = R A P:

        A_c[oc] = sum_{p,q,s : s = p+q-2*oc} wR[p] * wA[q](2i+p) * wP[s]

    Tensor coefficients of A are sampled at the even fine points."""
    if R.kind != "restriction" or P.kind != "prolongation":
        raise ValueError("galerkin_product expects (restriction, A, prolongation)")
    nd = A.ndim
    ent: Dict[Offset, object] = {}
    for ridx in np.ndindex(*R.weights.shape):
        wr = float(R.weights[ridx])
        if wr == 0.0:
            continue
        p = tuple(R.lo[d] + ridx[d] for d in range(nd))
        for q, wa in A.items():
            for sidx in np.ndindex(*P.weights.shape):
                wp = float(P.weights[sidx])
                if wp == 0.0:
                    continue
                s = tuple(P.lo[d] + sidx[d] for d in range(nd))
                num = tuple(p[d] + q[d] - s[d] for d in range(nd))
                if any(n % 2 for n in num):
                    continue
                oc = tuple(n // 2 for n in num)
                coef = wa
                if isinstance(wa, torch.Tensor) and wa.dim():
                    coef = _shift_coef(wa, p)[tuple(slice(None, None, 2) for _ in range(nd))]
                term = wr * coef * wp
                ent[oc] = ent[oc] + term if oc in ent else term
    return BoundStencil(f"({A.name})_galerkin", tuple(ent.keys()), tuple(ent.values()))


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


def node_restriction_integral(ndim: int) -> IntergridStencil:
    """Integral full weighting [1/2, 1, 1/2]^d (FV/FE residuals)."""
    return _separable("restriction", [0.5, 1.0, 0.5], -1, ndim)


def cell_restriction_integral(ndim: int) -> IntergridStencil:
    """Summation over the 2^d child cells."""
    return _separable("restriction", [1.0, 1.0], 0, ndim)


def cell_restriction(ndim: int) -> IntergridStencil:
    """Averaging over the 2^d child cells."""
    return _separable("restriction", [0.5, 0.5], 0, ndim)


def cell_prolongation(ndim: int) -> IntergridStencil:
    """Piecewise-constant injection to child cells."""
    return _separable("prolongation", [1.0, 1.0], 0, ndim)


def _mixed(kind: str, kernels, los) -> IntergridStencil:
    """Tensor-product window with per-dim kernels (face localizations mix
    the node kernel along the face dim with the cell kernel elsewhere)."""
    window = np.array(kernels[0], dtype=np.float64)
    for k in kernels[1:]:
        window = np.multiply.outer(window, np.array(k, dtype=np.float64))
    return IntergridStencil(kind, window, tuple(los),
                            tuple(tuple(float(v) for v in k) for k in kernels))


def face_restriction(face_dim: int, ndim: int, integral: bool = False) -> IntergridStencil:
    """Face_d restriction: node kernel along d, cell kernel elsewhere."""
    node_k = [0.5, 1.0, 0.5] if integral else [0.25, 0.5, 0.25]
    cell_k = [1.0, 1.0] if integral else [0.5, 0.5]
    kernels = [node_k if d == face_dim else cell_k for d in range(ndim)]
    los = [-1 if d == face_dim else 0 for d in range(ndim)]
    return _mixed("restriction", kernels, los)


def face_prolongation(face_dim: int, ndim: int, integral: bool = False) -> IntergridStencil:
    """Transpose of the matching restriction; 'linear' scales by 2^d."""
    p = face_restriction(face_dim, ndim, integral).transposed()
    return p if integral else p.scaled(float(2 ** ndim))
