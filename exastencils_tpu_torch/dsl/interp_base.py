"""Shared base pieces of the L4 interpreter: frames, loop contexts,
field-info records, control-flow exceptions, scalar helpers and the
arithmetic appliers used across the interpreter mixins.

Reference: exastencils_tpu/dsl/interp_base.py.  Values are Python
scalars, torch tensors (0-d scalars or grid-shaped) or MatVals.  The
tensor helpers at the end (`_iota`, `_and`, `_minmax`; `_pad` from
ops/stencil_apply) stand in for the jnp calls of the reference.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from exastencils_tpu_torch.core.grid import CELL, FACES, NODE
from exastencils_tpu_torch.core import matval as MV
from exastencils_tpu_torch.core.matval import is_mat
from exastencils_tpu_torch.core.stencil import BoundStencil, IntergridStencil
from exastencils_tpu_torch.ops.stencil_apply import _pad

_LOC_MAP = {
    "Node": NODE, "node": NODE, "Cell": CELL, "cell": CELL,
    "Face_x": FACES[0], "Face_y": FACES[1], "Face_z": FACES[2],
}


# A Python float that a staged run traces becomes a 0-d float64 tensor
# marked with this attribute (dsl/interp_staging): `_apply_binop` gives it
# the arithmetic of the Python float it stands for, and what it computes
# with other Python numbers is marked in turn.
_PY_FLOAT = "_exa_py_float"


def py_float(t: torch.Tensor) -> torch.Tensor:
    """Mark a 0-d float64 tensor as a traced Python float; returns it."""
    setattr(t, _PY_FLOAT, True)
    return t


def is_py_float(v) -> bool:
    return isinstance(v, torch.Tensor) and getattr(v, _PY_FLOAT, False)


def _math_fn(torch_fn, np_fn):
    """A math builtin on tensors (torch) and on Python numbers (numpy,
    returned as a Python float or complex, so it stays weakly typed)."""

    def fn(v):
        if isinstance(v, torch.Tensor):
            return py_float(torch_fn(v)) if is_py_float(v) else torch_fn(v)
        with np.errstate(all="ignore"):
            r = np_fn(v)
        return complex(r) if np.iscomplexobj(r) else float(r)

    return fn


def _abs(v):
    if isinstance(v, torch.Tensor):
        return py_float(torch.abs(v)) if is_py_float(v) else torch.abs(v)
    return abs(v)


_MATH_FNS = {
    "sqrt": _math_fn(torch.sqrt, np.sqrt), "fabs": _abs, "abs": _abs,
    "sin": _math_fn(torch.sin, np.sin), "cos": _math_fn(torch.cos, np.cos),
    "tan": _math_fn(torch.tan, np.tan), "sinh": _math_fn(torch.sinh, np.sinh),
    "cosh": _math_fn(torch.cosh, np.cosh), "exp": _math_fn(torch.exp, np.exp),
    "ln": _math_fn(torch.log, np.log), "log": _math_fn(torch.log, np.log),
    "floor": _math_fn(torch.floor, np.floor), "ceil": _math_fn(torch.ceil, np.ceil),
    "atan": _math_fn(torch.atan, np.arctan), "asin": _math_fn(torch.asin, np.arcsin),
    "acos": _math_fn(torch.acos, np.arccos),
}


def _dtype_info(dt: Optional[str]):
    """Interpret a canonical datatype string (dsl/parser.parse_datatype):
    returns (elem_shape, is_complex) — elem_shape () for scalars,
    (r, c) for the Matrix/Vector family (reference datatypes,
    L4_Parser.scala:175-205)."""
    if not dt:
        return (), False
    dt = dt.replace(" ", "")
    if "<" not in dt:
        m = re.fullmatch(r"Vec(\d+)", dt)  # Vec2/Vec3 shorthands
        if m:
            return (int(m.group(1)), 1), False
        return (), dt == "Complex"
    base, params = dt.split("<", 1)
    params = params.rstrip(">")
    is_c = params.startswith("Complex") or base == "Complex"
    # split ints off the tail
    ints = [p for p in params.split(",") if p.lstrip("-").isdigit()]
    if base == "Matrix":
        return (int(ints[-2]), int(ints[-1])), is_c
    if base in ("ColumnVector", "Vector", "Tensor1"):
        return (int(ints[-1]) if ints else 3, 1), is_c
    if base == "RowVector":
        return (1, int(ints[-1])), is_c
    if base == "Tensor2":
        n = int(ints[-1]) if ints else 3  # Tensor2<Real> defaults to dim 3
        return (n, n), is_c
    if base == "TensorN":
        # TensorN<T, dim, order> (reference IR_TensorDatatypeN); order-1
        # tensors share the column-vector layout so compare(tensN, tens1)
        # and compare(tensN-order-2, tens2) hold structurally
        d, o = int(ints[-2]), int(ints[-1])
        return ((d, 1) if o == 1 else (d,) * o), is_c
    if base == "Complex":
        return (), True
    return (), is_c


def _compensated_sum(vals, algo: str):
    """Kahan / Neumaier compensated summation in sequential order (the
    reference's lax.scan), element by element in the tensor's own dtype,
    so the result has the reference's bits.  Any other `algo` is a plain
    sum."""
    if algo not in ("kahan", "neumaier"):
        return torch.sum(vals)
    xs = vals.detach().cpu().numpy().reshape(-1)
    zero = xs.dtype.type(0)
    s = c = zero
    for x in xs:
        if algo == "kahan":
            y = x - c
            t = s + y
            s, c = t, (t - s) - y
        else:
            t = s + x
            c = c + (((s - t) + x) if abs(s) >= abs(x) else ((x - t) + s))
            s = t
    out = s if algo == "kahan" else s + c
    return torch.tensor(out, dtype=vals.dtype, device=vals.device)


def _glibc_rand_stream(seed: int = 1):
    """glibc's default random() / rand(): the TYPE_3 additive-feedback
    generator (r[i] = r[i-3] + r[i-31] mod 2^32, output >> 1) seeded by
    the LCG warm-up, exactly as initstate_r does.  Needed to reproduce
    the reference's `native("((double)std::rand()/RAND_MAX)")` field
    initialization digit-for-digit (Testing/Opts)."""
    r = [seed]
    for i in range(1, 31):
        # r[i] = (16807 * r[i-1]) % 2147483647 using the signed-overflow-
        # free formulation glibc documents
        hi, lo = divmod(r[i - 1], 127773)
        word = 16807 * lo - 2836 * hi
        if word < 0:
            word += 2147483647
        r.append(word)
    for i in range(31, 34):
        r.append(r[i - 31])
    i = 34
    while True:
        v = (r[i - 3] + r[i - 31]) & 0xFFFFFFFF
        r.append(v)
        if i >= 344:  # glibc discards the first 310 outputs
            yield v >> 1
        i += 1


class _FunctionBC:
    """Field boundary handled by a user L4 function (reference
    field decl `Field x< dom, layout, fnName() >`; `apply bc` calls it)."""

    def __init__(self, fn_name: str, level_spec):
        self.fn_name = fn_name
        self.level_spec = level_spec


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Exit(Exception):
    """DSL `exit(code)` — terminates Application (generated std::exit)."""

    def __init__(self, code: int):
        self.code = code


@dataclass
class _FieldInfo:
    name: str
    localization: str
    levels: List[int]
    bc_by_level: Dict[int, object] = dc_field(default_factory=dict)  # BC instances
    num_slots: int = 1
    ghost: int = 1
    elem_shape: Tuple[int, ...] = ()  # (r, c) for Matrix/Vector-valued fields
    is_complex: bool = False
    dup_layers: Optional[Tuple[int, ...]] = None  # None = default (1 per dim)


@dataclass
class Frame:
    vars: Dict[str, object]
    level: Optional[int]


@dataclass
class _LoopCtx:
    level: int
    localization: str
    shape: Tuple[int, ...]
    mask: Optional[torch.Tensor] = None  # color/condition mask
    reduction: Optional[Tuple[str, str]] = None



def _classify_mat_shape(M) -> List[str]:
    """Port of the reference's compile-time structure analysis
    (baseExt/ir/IR_ClassifyMatShape.scala:174-300 isSchurOrBlockdiag):
    detects diagonal / blockdiagonal(block) / schur(block, A, Ablock)
    forms from the nonzero pattern M (2D bool array)."""
    size = M.shape[0]
    if size == 1 or M.shape[1] == 1:
        return ["shape=filled"]
    # blocksize of the leading (block)diagonal A
    bA = 1
    while bA < size:
        if not any(M[i, bA] or M[bA, i] for i in range(bA)):
            break
        bA += 1
    # blocksize of the trailing Schur block D
    bD = 0
    while bD < size:
        if not any(
            M[i, size - bD - 1] or M[size - bD - 1, i]
            for i in range(size - bD - bA)
        ):
            break
        bD += 1
    if bD == size:
        return ["shape=filled"]
    if bA >= (size - bD) // 2 + 1:
        return ["shape=filled"]
    border = size - bD
    for i in range(border):
        start = (i // bA) * bA + bA
        for j in range(start, border):
            if M[i, j] or M[j, i]:
                return ["shape=filled"]
    if bD == 0:
        if bA == 1:
            return ["shape=diagonal"]
        if bA == size:
            return ["shape=filled"]
        return ["shape=blockdiagonal", f"block={bA}"]
    if bA == 1:
        return ["shape=schur", f"block={size - bD}", "A=diagonal"]
    if bA == size:
        return ["shape=filled"]
    return ["shape=schur", f"block={size - bD}", "A=blockdiagonal", f"Ablock={bA}"]


def _is_stencil(v) -> bool:
    return isinstance(v, tuple) and len(v) == 3 and v[0] == "__stencil__"


def _scale_stencil(st, s):
    """Scalar * stencil (reference IR_StencilOps.scale)."""
    if isinstance(st, BoundStencil):
        return BoundStencil(st.name, st.offsets, tuple(c * s for c in st.coefs))
    if isinstance(st, IntergridStencil):
        kernels = None
        if st.kernels_1d is not None:
            kernels = (tuple(v * s for v in st.kernels_1d[0]),) + tuple(
                st.kernels_1d[1:]
            )
        return IntergridStencil(st.kind, st.weights * s, st.lo, kernels)
    raise TypeError(f"cannot scale {st!r}")


def _logic(fn, a, b):
    """&& / || on tensors (either operand may be a Python value)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(bool(a), device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(bool(b), device=a.device)
    return fn(a, b)


def _int_scalar(v) -> bool:
    """A 0-d integer tensor: an int variable traced by a staged run."""
    return isinstance(v, torch.Tensor) and v.dim() == 0 and not (
        v.dtype.is_floating_point or v.dtype.is_complex or v.dtype == torch.bool)


_ARITH = ("+", "-", "*", "/", "%", "**")


def _apply_binop(op, a, b):
    if is_mat(a) or is_mat(b):
        return MV.mat_binop(op, a, b)
    # elementwise-operator spellings degenerate to scalar ops off-matrix
    op = {".*": "*", "./": "/", ".^": "**", ".%": "**"}.get(op, op)
    if (_int_scalar(a) or _int_scalar(b)) and op in _ARITH:
        # a traced int keeps Python's arithmetic: with a Python float, or
        # divided, it computes in float64 (torch would take float32)
        if isinstance(a, float) or isinstance(b, float) or is_py_float(a) \
                or is_py_float(b) or op == "/":
            a = py_float(a.double()) if _int_scalar(a) else a
            b = py_float(b.double()) if _int_scalar(b) else b
    pa, pb = is_py_float(a), is_py_float(b)
    if pa or pb:
        return _py_float_binop(op, a, b, pa)
    return _raw_binop(op, a, b)


def _py_float_binop(op, a, b, pa: bool):
    """`a op b` where a (pa) or b is a traced Python float: what PyTorch
    gives for the Python float itself.  With another Python number it is
    float64 arithmetic and a traced float again; against a tensor the
    float takes the tensor's type first, a division by it is a product
    with its reciprocal on CUDA (PyTorch's path for a Python-scalar
    divisor there, measured on an H100 with torch 2.11) and a division of
    it a product with the tensor's reciprocal (`Tensor.__rtruediv__`)."""
    other = b if pa else a
    if not isinstance(other, torch.Tensor) or is_py_float(other):
        if not isinstance(other, torch.Tensor):  # a Python number: float64 too
            f = a if pa else b
            other = torch.full((), other, device=f.device, dtype=torch.complex128
                               if isinstance(other, complex) else torch.float64)
            a, b = (f, other) if pa else (other, f)
        r = _raw_binop(op, a, b)
        if op in _ARITH and isinstance(r, torch.Tensor) and r.dtype == torch.float64:
            py_float(r)
        return r
    g = a if pa else b
    f = g.to(other.dtype if other.dtype.is_floating_point or other.dtype.is_complex
             else torch.get_default_dtype())
    if op == "/":
        if not pa:
            # on CUDA, PyTorch divides by a Python scalar as a product with
            # its reciprocal, taken in float64 and rounded to the type
            return other * torch.reciprocal(g).to(f.dtype) if other.is_cuda else other / f
        return other.reciprocal() * f
    return _raw_binop(op, f, other) if pa else _raw_binop(op, other, f)


def _raw_binop(op, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "%":
        return a % b
    if op == "**":
        return a ** b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    if op == "&&":
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            return _logic(torch.logical_and, a, b)
        return a and b
    if op == "||":
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            return _logic(torch.logical_or, a, b)
        return a or b
    raise ValueError(f"unknown operator {op}")


def _apply_assign(op, cur, val):
    if op == "=":
        if not isinstance(cur, torch.Tensor) or is_py_float(cur):
            return val
        if not isinstance(val, torch.Tensor):
            # a fill, not a copy from host memory (which a CUDA graph
            # capture refuses)
            return torch.full(cur.shape, val, dtype=cur.dtype, device=cur.device)
        return torch.broadcast_to(val.to(dtype=cur.dtype, device=cur.device), cur.shape)
    if is_py_float(cur) or is_py_float(val):
        return _apply_binop(op[0], cur, val)
    if op == "+=":
        return cur + val
    if op == "-=":
        return cur - val
    if op == "*=":
        return cur * val
    if op == "/=":
        return cur / val
    raise ValueError(f"unknown assign op {op}")


def _shift(arr, offset):
    """Field access with constant offset: zero-padded shifted view.
    Only the leading len(offset) dims shift (trailing matrix-element
    dims pass through)."""
    r = max(abs(o) for o in offset)
    if r == 0:
        return arr
    extra = arr.dim() - len(offset)
    xp = _pad(arr, ((r, r),) * len(offset) + ((0, 0),) * extra)
    sl = tuple(slice(r + o, r + o + n) for o, n in zip(offset, arr.shape))
    return xp[sl]


def _fmt(v, precision: int = 6) -> str:
    """C++ `std::cout <<` default formatting at the current stream
    precision (%.Ng general form; std::complex prints `(re,im)`)."""
    if isinstance(v, str):
        return v
    if is_mat(v):
        flat = v.data.detach().cpu().numpy().reshape(-1)
        return "[" + " ".join(_fmt(x, precision) for x in flat) + "]"
    if isinstance(v, torch.Tensor):
        v = v.item() if torch.is_complex(v) else float(v)
    if isinstance(v, complex) or np.iscomplexobj(v):
        c = complex(v)
        return "(%s,%s)" % (
            "%.*g" % (precision, c.real), "%.*g" % (precision, c.imag)
        )
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return str(int(v))
    if isinstance(v, (bool, np.bool_)):
        return "1" if v else "0"
    return "%.*g" % (precision, float(v))


# ----------------------------------------------------------------------
# tensor helpers (the jnp calls of the reference)
# ----------------------------------------------------------------------


def _minmax(name: str, vals):
    """Elementwise min/max over values of which at least one is a tensor
    (jnp.minimum/maximum of the reference).  A Python number becomes a 0-d
    tensor of its default type by a fill (no copy from host memory), a
    traced Python float (`is_py_float`) the same way."""
    fn = torch.minimum if name == "min" else torch.maximum
    ref = next(v for v in vals if isinstance(v, torch.Tensor))

    def weak(v):
        if is_py_float(v):
            return v.to(torch.get_default_dtype())
        return v if isinstance(v, torch.Tensor) else torch.full((), v, device=ref.device)

    out = vals[0]
    for v in vals[1:]:
        dt = torch.result_type(1.0 if is_py_float(out) else out, 1.0 if is_py_float(v) else v)
        out = fn(weak(out).to(dt), weak(v).to(dt))
    return out


def _iota(shape, d: int, device) -> torch.Tensor:
    """int32 index along dim d, broadcast to `shape` (lax.broadcasted_iota)."""
    view = [1] * len(shape)
    view[d] = shape[d]
    return torch.arange(shape[d], dtype=torch.int32, device=device).reshape(view).expand(tuple(shape))


def _and(a, b):
    """Mask conjunction where either side may be None (= everywhere) or
    a Python bool (a loop condition that does not depend on the point)."""
    if a is None or b is None:
        m = b if a is None else a
        return m if m is None or isinstance(m, torch.Tensor) else torch.as_tensor(bool(m))
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(bool(b), device=a.device)
    return torch.logical_and(a, b)
