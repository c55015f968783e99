"""AST node classes for ExaSlang 4.

Copied from exastencils_tpu/dsl/nodes.py so that the PyTorch port imports
nothing of the JAX package; imports point at exastencils_tpu_torch.

Reference: the node packages {base,baseExt,field,operator,...}/l4 — here
a compact dataclass tree; the interpreter (dsl/interpreter.py) stages it
onto the ops/solver layers instead of progressing to a C++ IR.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Tuple, Union


# ---------------- level specifications (parsers/l4/L4_Parser.scala:118-168)


class LevelSpec:
    def resolve(self, min_level: int, max_level: int, current: Optional[int] = None) -> List[int]:
        raise NotImplementedError


@dataclass
class LvlAll(LevelSpec):
    def resolve(self, lo, hi, current=None):
        return list(range(lo, hi + 1))


@dataclass
class LvlSingle(LevelSpec):
    level: int

    def resolve(self, lo, hi, current=None):
        return [self.level]


@dataclass
class LvlFinest(LevelSpec):
    offset: int = 0

    def resolve(self, lo, hi, current=None):
        return [hi + self.offset]


@dataclass
class LvlCoarsest(LevelSpec):
    offset: int = 0

    def resolve(self, lo, hi, current=None):
        return [lo + self.offset]


@dataclass
class LvlRelative(LevelSpec):
    delta: int  # @coarser = -1, @finer = +1, @current = 0, @current+n

    def resolve(self, lo, hi, current=None):
        if current is None:
            raise ValueError("relative level outside a leveled context")
        return [current + self.delta]


@dataclass
class LvlRange(LevelSpec):
    lo_spec: LevelSpec
    hi_spec: LevelSpec

    def resolve(self, lo, hi, current=None):
        a = self.lo_spec.resolve(lo, hi, current)[0]
        b = self.hi_spec.resolve(lo, hi, current)[0]
        return list(range(a, b + 1))


@dataclass
class LvlList(LevelSpec):
    specs: List[LevelSpec]

    def resolve(self, lo, hi, current=None):
        out = []
        for s in self.specs:
            out.extend(s.resolve(lo, hi, current))
        return sorted(set(out))


@dataclass
class LvlAllBut(LevelSpec):
    base: LevelSpec
    excluded: LevelSpec

    def resolve(self, lo, hi, current=None):
        ex = set(self.excluded.resolve(lo, hi, current))
        return [l for l in self.base.resolve(lo, hi, current) if l not in ex]


# ---------------- expressions


class Expr:
    pass


@dataclass
class Num(Expr):
    value: float
    is_int: bool = False
    is_imag: bool = False  # `0.5j` complex literal (ComplexNumbers/)


@dataclass
class Str(Expr):
    value: str


@dataclass
class BinOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr


@dataclass
class UnOp(Expr):
    op: str
    operand: Expr


@dataclass
class Access(Expr):
    """Identifier access: variable, field, stencil or virtual field —
    resolved at execution time.  Carries optional @level, [offset] and
    <slot> modifiers (L4_Parser field/stencil access productions)."""

    name: str
    level: Optional[LevelSpec] = None
    offset: Optional[Tuple[int, ...]] = None
    slot: Optional[str] = None  # 'active' | 'next' | 'previous' | int as str
    # matrix/vector component access `m[i][j]`, `m[0:2][:]`, `v[i]`:
    # list of ('idx', expr) | ('slice', lo_expr|None, hi_expr|None)
    component: Optional[Tuple] = None
    # stencil-field entry designator `A:[-1,0]` (reference L4 stencil
    # field access, field/l4/L4_StencilFieldAccess offset selection)
    sten_entry: Optional[Tuple[int, ...]] = None


@dataclass
class Call(Expr):
    name: str
    level: Optional[LevelSpec]
    args: List[Expr]


@dataclass
class TensorLit(Expr):
    """`tens1{ n ; [i] := v, ... }` / `tens2{ n ; [i,j] := v, ... }`
    (baseExt tensor expressions, Testing/TensorClass)."""

    order: int
    dim: int
    entries: List[Tuple[Tuple[int, ...], "Expr"]]


@dataclass
class MatrixLit(Expr):
    """`{ {a, b}, {c, d} }` matrix / `{a, b}` column-vector literal
    (baseExt/l4 matrix expressions; used as stencil coefficients in the
    vector-valued suites, e.g. Testing/Application/OpticalFlow2D)."""

    rows: List[List[Expr]]


# ---------------- statements


class Stmt:
    pass


@dataclass
class VarDecl(Stmt):
    name: str
    datatype: str
    init: Optional[Expr]
    is_val: bool = False


@dataclass
class Assign(Stmt):
    target: Access
    op: str  # '=', '+=', '-=', '*=', '/='
    value: Expr


@dataclass
class If(Stmt):
    cond: Expr
    then_body: List[Stmt]
    else_body: List[Stmt] = dc_field(default_factory=list)


@dataclass
class RepeatTimes(Stmt):
    count: Expr
    body: List[Stmt]
    count_var: Optional[str] = None
    contraction: Optional[Tuple[int, ...]] = None


@dataclass
class RepeatUntil(Stmt):
    cond: Expr
    body: List[Stmt]
    is_while: bool = False  # while = check before, until = check before w/ negation


@dataclass
class LoopOverField(Stmt):
    field: Access
    body: List[Stmt]
    region: Optional[Tuple[str, Optional[Tuple[int, ...]]]] = None  # ('ghost'|'dup'|'inner', dir)
    on_boundary: bool = False
    reduction: Optional[Tuple[str, str]] = None  # (op, var)
    condition: Optional[Expr] = None
    sequentially: bool = False
    starting: Optional[Tuple[int, ...]] = None
    ending: Optional[Tuple[int, ...]] = None
    stepping: Optional[Tuple[int, ...]] = None


@dataclass
class LoopOverFragments(Stmt):
    body: List[Stmt]
    reduction: Optional[Tuple[str, str]] = None


@dataclass
class ColorWith(Stmt):
    colors: Expr  # expression of the form f(i0..) % n
    body: List[Stmt]
    # additional `expr % n` colorings (cross-product semantics, e.g.
    # `color with { i0 % 3, i1 % 3, ... }` = 9-coloring; reference
    # L4_ColorLoops with a color list)
    more_colors: List[Expr] = dc_field(default_factory=list)


@dataclass
class RepeatWith(Stmt):
    """`repeat with { cond0, cond1, ..., stmts }` — run the body once per
    condition, masking contained field loops (L4_Parser.scala:337)."""

    conditions: List[Expr]
    body: List[Stmt]


@dataclass
class LevelScope(Stmt):
    """`@finest { ... }` — statements executed only on matching levels
    (L4 leveled scopes)."""

    levels: "LevelSpec"
    body: List[Stmt]


@dataclass
class Communicate(Stmt):
    field: Access
    op: str = "both"  # 'begin' | 'finish' | 'both'
    targets: List[str] = dc_field(default_factory=list)  # 'all' | 'dup' | 'ghost'


@dataclass
class ApplyBC(Stmt):
    field: Access


@dataclass
class Advance(Stmt):
    field: Access


@dataclass
class Return(Stmt):
    value: Optional[Expr] = None


@dataclass
class Break(Stmt):
    pass


@dataclass
class ExprStmt(Stmt):
    expr: Expr


@dataclass
class SolveMatSys(Stmt):
    """`solveMatSys A, u, f [{shape=...}]` — dense local system solve
    (L4_Parser.scala:349, IR_MatrixSolveOps); shape hints are accepted
    and ignored (XLA's batched LU solves all shapes)."""

    A: Access
    u: Access
    f: Access


@dataclass
class SolveLocally(Stmt):
    """`solve locally [with jacobi] [relax w] { u => eq ... }`
    (L4_Parser.scala:333-334; Vanka building block)."""

    unknowns: List[Access]
    equations: List[Tuple[Expr, Expr]]  # lhs == rhs per unknown
    jacobi_type: bool = False
    relax: Optional[Expr] = None


# ---------------- declarations


@dataclass
class DomainDecl:
    name: str
    lower: List[float]
    upper: List[float]


@dataclass
class LayoutDecl:
    name: str
    datatype: str
    localization: str
    levels: Optional[LevelSpec]
    dup_layers: Optional[Tuple[int, ...]] = None
    dup_comm: bool = False
    ghost_layers: Optional[Tuple[int, ...]] = None
    ghost_comm: bool = False
    inner_points: Optional[Tuple[int, ...]] = None


@dataclass
class FieldDecl:
    name: str
    domain: str
    layout: str
    bc: Optional[Expr]  # None | expr | Call('Neumann', order)
    levels: Optional[LevelSpec]
    num_slots: int = 1


@dataclass
class StencilOffsetEntry:
    offsets: List[Expr]
    coef: Expr


@dataclass
class StencilMappingEntry:
    to_indices: List[str]  # e.g. ['i0', 'i1']
    from_exprs: List[Expr]
    coef: Expr


@dataclass
class StencilDecl:
    name: str
    levels: Optional[LevelSpec]
    entries: List[Union[StencilOffsetEntry, StencilMappingEntry]]


@dataclass
class StencilFromDefault:
    """`Stencil id from default restriction|prolongation on <loc> with
    '<interp>'` (reference L3_DefaultRestriction/Prolongation)."""

    name: str
    kind: str  # 'restriction' | 'prolongation'
    localization: str
    interpolation: str
    levels: Optional[LevelSpec] = None


@dataclass
class StencilFromExpr:
    """`Stencil id [@lvl] from ( <stencil expression> )` — stencil
    algebra over previously declared stencils (operator/l4
    L4_OperatorFromEquation / IR_StencilOps combinations)."""

    name: str
    levels: Optional[LevelSpec]
    expr: Expr


@dataclass
class StencilFieldDecl:
    name: str
    field: str
    stencil: str
    levels: Optional[LevelSpec]


@dataclass
class StencilTemplateDecl:
    """`Operator A from StencilTemplate on <loc> of <dom> { [off] => }`
    (reference operator/l2 L2_StencilTemplateDecl): a stencil whose
    per-offset coefficients are a field, assembled at runtime via
    `loop over A { A:[off] = ... }`."""

    name: str
    localization: str
    domain: str
    offsets: List[Tuple[int, ...]]
    levels: Optional[LevelSpec] = None


@dataclass
class FunctionDecl:
    name: str
    levels: Optional[LevelSpec]
    params: List[Tuple[str, str]]  # (name, type)
    rettype: str
    body: List[Stmt]
    noinline: bool = False


@dataclass
class GlobalsDecl:
    decls: List[VarDecl]


DIRECTION_OFFSETS = {
    "center": (0, 0, 0), "east": (1, 0, 0), "west": (-1, 0, 0),
    "north": (0, 1, 0), "south": (0, -1, 0),
    "top": (0, 0, 1), "bottom": (0, 0, -1),
}


def resolve_direction_aliases(node, ndim: int):
    """Replace direction-alias offsets ('east', ...) with concrete
    dimensionality-sized tuples, in place (reference
    util/l4/L4_OffsetAlias.toConstIndex).  Idempotent."""
    import dataclasses as _dc

    def conv(name):
        full = DIRECTION_OFFSETS[name]
        if any(full[d] != 0 for d in range(ndim, 3)):
            # e.g. `F@top` in a 2D program: truncating would silently
            # yield a (0,0) center access (advisor r4)
            raise ValueError(
                f"direction alias '{name}' lies outside a {ndim}D program"
            )
        return tuple(full[:ndim])

    def walk(x):
        if isinstance(x, Access) and isinstance(x.offset, str):
            x.offset = conv(x.offset)
        if isinstance(x, StencilOffsetEntry) and isinstance(x.offsets, str):
            x.offsets = [Num(o, is_int=True) for o in conv(x.offsets)]
        if _dc.is_dataclass(x) and not isinstance(x, type):
            for f in _dc.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(node)
    return node


def shift_offsets(node, off):
    """Rebuild an expression with `off` added to every Access offset —
    the evaluation rule for `exprAlias@[off]` (an L4 Expr alias accessed
    with an offset shifts all its contained accesses)."""
    import dataclasses as _dc

    def add(a):
        if a is None:
            return tuple(off)
        return tuple(x + o for x, o in zip(tuple(a) + (0,) * len(off), off))

    def walk(x):
        if isinstance(x, Access):
            return Access(x.name, level=x.level, offset=add(x.offset),
                          slot=x.slot, component=walk(x.component),
                          sten_entry=x.sten_entry)
        if _dc.is_dataclass(x) and not isinstance(x, type):
            return type(x)(**{
                f.name: walk(getattr(x, f.name)) for f in _dc.fields(x)
            })
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        return x

    return walk(node)


def substitute(node, mapping):
    """Template-parameter substitution over the AST (FunctionTemplate /
    Instantiate generics, L4_Parser.scala:218-221): every Access whose
    name is a template parameter is replaced by the instantiation
    argument; Access modifiers merge (the argument's level/slot win,
    the use site's offset/component stay)."""
    import dataclasses as _dc

    def sub(x):
        if isinstance(x, Access) and x.name in mapping:
            r = mapping[x.name]
            if isinstance(r, Access):
                return Access(
                    r.name,
                    level=r.level if r.level is not None else x.level,
                    offset=x.offset if x.offset is not None else r.offset,
                    slot=r.slot if r.slot is not None else x.slot,
                    component=x.component or r.component,
                    sten_entry=x.sten_entry or r.sten_entry,
                )
            return sub_generic(r)  # literal / expression argument
        if isinstance(x, Call) and x.name in mapping:
            # a CALLED template parameter (ExaFluids' recursive
            # templates take their own instantiated name as `self`)
            r = mapping[x.name]
            if isinstance(r, Access):
                return Call(r.name,
                            x.level if x.level is not None else r.level,
                            [sub(a) for a in x.args])
        return sub_generic(x)

    def sub_generic(x):
        if _dc.is_dataclass(x) and not isinstance(x, type):
            return type(x)(**{
                f.name: sub(getattr(x, f.name)) for f in _dc.fields(x)
            })
        if isinstance(x, list):
            return [sub(v) for v in x]
        if isinstance(x, tuple):
            return tuple(sub(v) for v in x)
        return x

    return sub(node)


@dataclass
class Program:
    domains: List[DomainDecl] = dc_field(default_factory=list)
    layouts: List[LayoutDecl] = dc_field(default_factory=list)
    fields: List[FieldDecl] = dc_field(default_factory=list)
    stencils: List[StencilDecl] = dc_field(default_factory=list)
    stencil_fields: List[StencilFieldDecl] = dc_field(default_factory=list)
    stencil_templates: List[StencilTemplateDecl] = dc_field(default_factory=list)
    functions: List[FunctionDecl] = dc_field(default_factory=list)
    globals_: List[VarDecl] = dc_field(default_factory=list)
    inline_knowledge: dict = dc_field(default_factory=dict)
    equations: List[tuple] = dc_field(default_factory=list)  # (name, lvl, lhs, rhs)
