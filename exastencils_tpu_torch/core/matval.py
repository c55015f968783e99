"""Matrix/vector values for the ExaSlang Matrix<T,r,c> datatype family.

Reference: exastencils_tpu/core/matval.py.  A MatVal wraps one tensor of
shape batch_shape + (rows, cols): a plain Var has batch_shape (), a
matrix-valued field carries the grid as batch dims, so every matrix
operation (matmul, batched inverse/solve) is one torch op over the grid.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class MatVal:
    """data: tensor, shape = batch + (rows, cols)."""

    data: torch.Tensor

    @property
    def rows(self) -> int:
        return self.data.shape[-2]

    @property
    def cols(self) -> int:
        return self.data.shape[-1]

    @property
    def batch(self):
        return tuple(self.data.shape[:-2])

    def map(self, fn) -> "MatVal":
        return MatVal(fn(self.data))

    # scalar scaling / elementwise sum (matrix-valued stencil coefficients
    # under stencil algebra)
    def __mul__(self, other):
        if isinstance(other, MatVal):
            return NotImplemented
        return MatVal(self.data * other)

    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, MatVal):
            return MatVal(self.data + other.data)
        return MatVal(self.data + other)

    __radd__ = __add__

    def __neg__(self):
        return MatVal(-self.data)

    def __repr__(self):
        return f"MatVal{tuple(self.data.shape)}"


def is_mat(v) -> bool:
    return isinstance(v, MatVal)


def _lift(other):
    """Grid-shaped tensors (scalar fields) gain trailing element dims so
    they scale every matrix entry at their grid point; scalars pass."""
    if isinstance(other, torch.Tensor) and other.dim():
        return other[..., None, None]
    return other


def mat_binop(op: str, a, b):
    """`*` between two matrices is the matrix product; `+ - .* ./ .^` are
    elementwise; scalars broadcast."""
    if is_mat(a) and is_mat(b):
        x, y = a.data, b.data
        if op == "*":
            if a.rows == 1 and a.cols == 1:
                return MatVal(x[..., 0:1, 0:1] * y)
            if b.rows == 1 and b.cols == 1:
                return MatVal(x * y[..., 0:1, 0:1])
            return MatVal(torch.matmul(x, y))
        if op in ("+", ".+"):
            return MatVal(x + y)
        if op in ("-", ".-"):
            return MatVal(x - y)
        if op == ".*":
            return MatVal(x * y)
        if op == "./":
            return MatVal(x / y)
        if op in (".^", "**"):
            return MatVal(x ** y)
        raise ValueError(f"unsupported matrix-matrix operator {op!r}")
    if is_mat(a):
        s = _lift(b)
        if op in ("+", ".+"):
            return MatVal(a.data + s)
        if op in ("-", ".-"):
            return MatVal(a.data - s)
        if op in ("*", ".*"):
            return MatVal(a.data * s)
        if op in ("/", "./"):
            return MatVal(a.data / s)
        if op in ("**", ".^"):
            return MatVal(a.data ** s)
        raise ValueError(f"unsupported matrix-scalar operator {op!r}")
    if is_mat(b):
        s = _lift(a)
        if op in ("+", ".+"):
            return MatVal(s + b.data)
        if op in ("-", ".-"):
            return MatVal(s - b.data)
        if op in ("*", ".*"):
            return MatVal(s * b.data)
        if op in ("/", "./"):
            return MatVal(s / b.data)
        raise ValueError(f"unsupported scalar-matrix operator {op!r}")
    raise TypeError("mat_binop requires a MatVal operand")


# ---------------------------------------------------------------- builtins


def transpose(m: MatVal) -> MatVal:
    return MatVal(torch.swapaxes(m.data, -1, -2))


def trace(m: MatVal):
    return torch.diagonal(m.data, dim1=-2, dim2=-1).sum(-1)


def determinant(m: MatVal):
    """det via LU, batched over the grid dims."""
    return torch.linalg.det(m.data)


def inverse(m: MatVal) -> MatVal:
    """Batched dense inverse (LU)."""
    return MatVal(torch.linalg.inv(m.data))


def frobenius_norm(m: MatVal):
    return torch.sqrt(torch.sum(torch.abs(m.data) ** 2, dim=(-2, -1)))


def dot_product(a: MatVal, b: MatVal) -> MatVal:
    """Sum of elementwise products, as a 1x1 matrix."""
    x, y = a.data, b.data
    if a.rows != b.rows or a.cols != b.cols:
        y = torch.swapaxes(y, -1, -2)
    s = torch.sum(x * y, dim=(-2, -1))
    return MatVal(s[..., None, None])


def cross(a: MatVal, b: MatVal) -> MatVal:
    """3-vector cross product."""
    x = a.data[..., :, 0] if a.cols == 1 else a.data[..., 0, :]
    y = b.data[..., :, 0] if b.cols == 1 else b.data[..., 0, :]
    return MatVal(torch.linalg.cross(x, y, dim=-1)[..., :, None])


def get_slice(m: MatVal, off_r, off_c, n_r, n_c) -> MatVal:
    r0, c0 = int(off_r), int(off_c)
    return MatVal(m.data[..., r0:r0 + int(n_r), c0:c0 + int(n_c)])


def set_slice(m: MatVal, off_r, off_c, n_r, n_c, value) -> MatVal:
    sl = (..., slice(int(off_r), int(off_r) + int(n_r)),
          slice(int(off_c), int(off_c) + int(n_c)))
    v = value.data if is_mat(value) else value
    out = m.data.clone()
    out[sl] = torch.broadcast_to(torch.as_tensor(v, dtype=out.dtype, device=out.device),
                                 out[sl].shape)
    return MatVal(out)
