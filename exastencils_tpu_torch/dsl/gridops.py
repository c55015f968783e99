"""Grid integrals and face evaluations as AST rewrites.

Copied from exastencils_tpu/dsl/gridops.py so that the PyTorch port imports
nothing of the JAX package; imports point at exastencils_tpu_torch.

Reference counterparts: grid/ir/IR_IntegrateOnGrid.scala and
grid/ir/IR_EvaluateOnGrid.scala — `integrateOver[XStaggered]<Face>Face(e)`
and `evalAt<Face>Face(e)` calls are resolved by placing the (possibly
staggered) control volume, locating the face center, linearly
interpolating each field factor of the integrand to that position, and
multiplying by the face area.

Here the resolution is a pure AST -> AST rewrite done once per call
site: field accesses become (sums of) offset accesses with 1/2 weights
and the area becomes a product of `vf_gridWidth_*` accesses, so the
rewritten expression evaluates on whole grid arrays through the normal
interpreter/staging path (XLA fuses the interpolation averages into the
surrounding expression).

Position algebra (uniform axis-aligned grids, half-index units):
  localization sample positions: Node 0, Cell 1, Face_d: 0 in dim d
  else 1 (i.e. x_i = i*h resp. (i+1/2)*h).
  staggered-CV(s) center: 0 in dim s, 1 elsewhere; unstaggered CV =
  the cell (center 1 in every dim).  Faces sit center +- 1 in the face
  dim.  A field evaluated at a target position with matching parity is
  a direct (offset) access; mismatched parity averages the two
  neighbors (reference IR_EvaluateOnGrid linear interpolation).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

from exastencils_tpu_torch.dsl import nodes as N

_FACE_DIMS = {"East": (0, +1), "West": (0, -1),
              "North": (1, +1), "South": (1, -1),
              "Top": (2, +1), "Bottom": (2, -1)}
_STAG = {"X": 0, "Y": 1, "Z": 2}

_CALL_RE = re.compile(
    r"^(integrateOver|evalAt)(?:([XYZ])Staggered)?"
    r"(East|West|North|South|Top|Bottom)Face$"
)

# sample-position parity per localization, in half-index units
_LOC_SHIFT = {
    "Node": lambda d, nd: 0,
    "Cell": lambda d, nd: 1,
    "Face_x": lambda d, nd: 0 if d == 0 else 1,
    "Face_y": lambda d, nd: 0 if d == 1 else 1,
    "Face_z": lambda d, nd: 0 if d == 2 else 1,
}


def parse_grid_call(name: str) -> Optional[Tuple[str, Optional[int], int, int]]:
    """(kind, staggered_dim|None, face_dim, side) or None."""
    m = _CALL_RE.match(name)
    if not m:
        return None
    kind = "integrate" if m.group(1) == "integrateOver" else "eval"
    stag = _STAG[m.group(2)] if m.group(2) else None
    d, side = _FACE_DIMS[m.group(3)]
    return kind, stag, d, side


def _num(v: float) -> N.Expr:
    return N.Num(float(v))


def _interp_access(e: N.Access, target: List[int], ndim: int,
                   loc: str) -> N.Expr:
    """Field access linearly interpolated to `target` (half-index units
    relative to the CV's base index): a weighted sum of offset accesses."""
    shift_of = _LOC_SHIFT[loc]
    base_off = e.offset or (0,) * ndim
    # per-dim: list of (offset, weight) alternatives
    per_dim: List[List[Tuple[int, float]]] = []
    for d in range(ndim):
        delta = target[d] - shift_of(d, ndim)
        if delta % 2 == 0:
            per_dim.append([(delta // 2, 1.0)])
        else:
            per_dim.append([((delta - 1) // 2, 0.5), ((delta + 1) // 2, 0.5)])
    terms: List[Tuple[Tuple[int, ...], float]] = [((), 1.0)]
    for alts in per_dim:
        terms = [(off + (o,), w * ww) for off, w in terms for o, ww in alts]
    out: Optional[N.Expr] = None
    for off, w in terms:
        total = tuple(int(b) + int(o) for b, o in zip(base_off, off))
        acc = N.Access(e.name, e.level, total if any(total) else None,
                       e.slot, e.component)
        term = acc if w == 1.0 else N.BinOp("*", _num(w), acc)
        out = term if out is None else N.BinOp("+", out, term)
    return out


def _map_integrand(e: N.Expr, target: List[int], ndim: int,
                   loc_of: Callable[[str], Optional[str]]) -> N.Expr:
    """Rewrite every field access in the integrand to its interpolation
    at the face-center position."""
    if isinstance(e, N.Access):
        loc = loc_of(e.name)
        if loc is None or e.name.startswith("vf_"):
            return e
        return _interp_access(e, target, ndim, loc)
    if isinstance(e, N.BinOp):
        return N.BinOp(e.op, _map_integrand(e.lhs, target, ndim, loc_of),
                       _map_integrand(e.rhs, target, ndim, loc_of))
    if isinstance(e, N.UnOp):
        return N.UnOp(e.op, _map_integrand(e.operand, target, ndim, loc_of))
    if isinstance(e, N.Call):
        return N.Call(e.name, e.level,
                      [_map_integrand(a, target, ndim, loc_of) for a in e.args])
    return e


def expand_grid_call(e: N.Call, ndim: int,
                     loc_of: Callable[[str], Optional[str]]) -> Optional[N.Expr]:
    """Expand one integrate/eval call, or None if the name is not one."""
    parsed = parse_grid_call(e.name)
    if parsed is None:
        return None
    kind, stag, fd, side = parsed
    if fd >= ndim:
        raise ValueError(f"{e.name}: face dim out of range for {ndim}D")
    # CV center in half-index units
    center = [0 if d == stag else 1 for d in range(ndim)]
    target = list(center)
    target[fd] += side
    arg = e.args[0] if e.args else _num(1.0)
    body = _map_integrand(expand_grid_calls(arg, ndim, loc_of),
                          target, ndim, loc_of)
    if kind == "eval":
        return body
    # face area: product of grid widths over the non-face dims
    area: Optional[N.Expr] = None
    for d in range(ndim):
        if d == fd:
            continue
        w = N.Access(f"vf_gridWidth_{'xyz'[d]}")
        area = w if area is None else N.BinOp("*", area, w)
    return body if area is None else N.BinOp("*", area, body)


def expand_grid_calls(e: N.Expr, ndim: int,
                      loc_of: Callable[[str], Optional[str]]) -> N.Expr:
    """Recursively expand all integrate/eval grid calls in `e`."""
    if isinstance(e, N.Call):
        out = expand_grid_call(e, ndim, loc_of)
        if out is not None:
            return out
        return N.Call(e.name, e.level,
                      [expand_grid_calls(a, ndim, loc_of) for a in e.args])
    if isinstance(e, N.BinOp):
        return N.BinOp(e.op, expand_grid_calls(e.lhs, ndim, loc_of),
                       expand_grid_calls(e.rhs, ndim, loc_of))
    if isinstance(e, N.UnOp):
        return N.UnOp(e.op, expand_grid_calls(e.operand, ndim, loc_of))
    return e


def contains_grid_call(e: N.Expr) -> bool:
    if isinstance(e, N.Call):
        if parse_grid_call(e.name):
            return True
        return any(contains_grid_call(a) for a in e.args)
    if isinstance(e, N.BinOp):
        return contains_grid_call(e.lhs) or contains_grid_call(e.rhs)
    if isinstance(e, N.UnOp):
        return contains_grid_call(e.operand)
    return False
