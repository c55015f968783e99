"""`generate solver for u in uEq` expansion: L3 -> L4 program synthesis.

Copied from exastencils_tpu/dsl/solvergen.py so that the PyTorch port imports
nothing of the JAX package; imports point at exastencils_tpu_torch.

Reference counterpart: solver/l3/L3_SolverForEquation.scala:52-177 (field
and operator generation), L3_IterativeSolverForEquation /
L3_ConjugateGradientForEquation.scala:37, L3_BiCGStabForEquation,
L3_MinResForEquation, L3_ConjugateResidualForEquation (coarse-grid
solver templates), and app/l4's L4_AddCommunicationToLoops (the
communicate / apply-bc insertion that shows up in the generated L4).

The output is deliberately *the same L4 program text-shape* as the
reference's debug-L4 dump (Examples/Poisson/2D_FD_Poisson_fromL4.exa4),
so the residual sequences match the committed goldens digit-for-digit:
mgCycle@(all but coarsest) with color-split (or sequential-GS) smoother
sweeps, mgCycle@coarsest running the selected Krylov CGS, Solve@finest
with the reduced-precision residual printing protocol, and a default
Application (applications/l4/L4_AddDefaultApplication.scala).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

from exastencils_tpu_torch.dsl import nodes as N


# ---------------------------------------------------------------- helpers

def acc(name, level=None, offset=None, slot=None) -> N.Access:
    return N.Access(name, level=level, offset=offset, slot=slot)


def call(name, *args, level=None) -> N.Call:
    return N.Call(name, level, list(args))


def num(v) -> N.Num:
    return N.Num(float(v), is_int=float(v) == int(v) and isinstance(v, int))


def binop(op, a, b) -> N.BinOp:
    return N.BinOp(op, a, b)


def assign(target, op, value) -> N.Assign:
    return N.Assign(target, op, value)


def loop_over(field_acc, body, reduction=None, sequentially=False) -> N.LoopOverField:
    return N.LoopOverField(field_acc, body, reduction=reduction,
                           sequentially=sequentially)


def var(name, dtype, init) -> N.VarDecl:
    return N.VarDecl(name, dtype, init)


_COARSER = N.LvlRelative(-1)
_FINEST = N.LvlFinest()
_COARSEST = N.LvlCoarsest()
_ALL_BUT_COARSEST = N.LvlAllBut(N.LvlAll(), N.LvlCoarsest())
_ALL_BUT_FINEST = N.LvlAllBut(N.LvlAll(), N.LvlFinest())
_COARSEST_AND_FINEST = N.LvlList([N.LvlCoarsest(), N.LvlFinest()])


def _testing_print(value_expr, flag: str) -> List[N.Stmt]:
    """The reference's testing-aware print protocol
    (util/l4 printWithReducedPrec under testing_enabled)."""
    return [
        N.If(
            call("getKnowledge", N.Str("testing_enabled")),
            [
                N.If(
                    call("getKnowledge", N.Str(flag)),
                    [N.ExprStmt(call("printWithReducedPrec", value_expr))],
                )
            ],
            [],
        )
    ]


def _print_nontesting(args) -> N.Stmt:
    return N.If(
        N.UnOp("!", call("getKnowledge", N.Str("testing_enabled"))),
        [N.ExprStmt(call("print", *args))],
        [],
    )


# ---------------------------------------------------------------- spec

@dataclass
class EqTerm:
    """One `[coef *] Operator * field` product on an equation lhs; coef
    is an optional scalar-expression factor (field accesses allowed —
    LinearElasticity's `(lambda + mu) * (dxx * u)`)."""

    operator: str
    field: str
    coef: object = None  # Optional[N.Expr]


@dataclass
class EqEntry:
    """`lhs == rhs` with lhs a sum of operator*field terms; `unknown`
    names the solved-for field (reference L3_SolverForEqEntry)."""

    unknown: str
    rhs: str
    terms: List[EqTerm]
    localization: str = "Node"

    @property
    def main_operator(self) -> str:
        for t in self.terms:
            if t.field == self.unknown:
                return t.operator
        raise ValueError(f"no diagonal operator for unknown {self.unknown}")


@dataclass
class SolverSpec:
    entries: List[EqEntry]
    options: Dict[str, object] = dc_field(default_factory=dict)
    # (action, target, level_spec|None, stmts) with action in
    # append|prepend|replace, target in cycle|solver|smoother|cgs
    modifiers: List[Tuple[str, str, Optional[N.LevelSpec], List[N.Stmt]]] = dc_field(
        default_factory=list
    )


# ---------------------------------------------------------------- generator

class SolverGenerator:
    """Expands a SolverSpec into L4 declarations + functions."""

    def __init__(self, spec: SolverSpec, knowledge):
        self.spec = spec
        self.k = knowledge
        o = dict(spec.options)
        g = lambda key, default: o.get(key, getattr(knowledge, key, default))
        self.target_res = float(g("solver_targetResReduction", 1e-5))
        self.abs_res = float(g("solver_absResThreshold", 0.0))
        self.max_its = int(g("solver_maxNumIts", 128))
        self.use_fas = bool(g("solver_useFAS", False))
        self.coloring = str(g("solver_smoother_coloring", "None"))
        self.damping = float(g("solver_smoother_damping", 1.0))
        self.num_pre = int(g("solver_smoother_numPre", 3))
        self.num_post = int(g("solver_smoother_numPost", 3))
        self.jacobi_type = bool(g("solver_smoother_jacobiType", False))
        self.cgs = str(g("solver_cgs", "CG"))
        self.cgs_max_its = int(g("solver_cgs_maxNumIts", 512))
        self.cgs_target_res = float(g("solver_cgs_targetResReduction", 1e-3))
        self.cgs_abs_res = float(g("solver_cgs_absResThreshold", 0.0))
        self.cgs_restart = bool(g("solver_cgs_restart", False))
        self.cgs_restart_after = int(g("solver_cgs_restartAfter", 1000))
        self.silent = bool(g("solver_silent", False))
        self.ndim = knowledge.dimensionality
        # coupled-through-rhs systems (BiHarmonic: `L*u == v` with v an
        # unknown of the SAME solve): normalize the unknown onto the
        # operator side with a dedicated gen_rhs per entry (reference
        # L3_SolverForEqEntry equation preparation) — otherwise the
        # restriction target `v@coarser` doubles as the other entry's
        # coarse unknown, the coarse init re-zeroes it, and the coarse
        # correction equation silently loses this entry's restricted
        # residual (observed: BiHarmonic stalls at ~0.9/cycle)
        unknowns = {e.unknown for e in spec.entries}
        self._extra_stencils: List[N.StencilDecl] = []
        self._gen_rhs_entries: List[EqEntry] = []
        for e in spec.entries:
            coupled = e.rhs in unknowns
            if coupled:
                ident = "gen_negIdentity"
                if not self._extra_stencils:
                    self._extra_stencils.append(N.StencilDecl(
                        ident, None,
                        [N.StencilOffsetEntry(
                            [N.Num(0, True)] * self.ndim, num(-1.0))],
                    ))
                e.terms.append(EqTerm(ident, e.rhs))
            if coupled or e.rhs is None:
                # literal-zero rhs (LinearElasticity) also needs the
                # dedicated field: coarser levels receive the restricted
                # residual
                e.rhs = f"gen_rhs{self._suffix(e)}"
                self._gen_rhs_entries.append(e)

    # -------------------------------------------------- names
    def res_field(self, e: EqEntry) -> str:
        return "gen_residual" if len(self.spec.entries) == 1 else f"gen_residual_{e.unknown}"

    def _suffix(self, e: EqEntry) -> str:
        return "" if len(self.spec.entries) == 1 else f"_{e.unknown}"

    # -------------------------------------------------- declarations
    def field_decls(self) -> List[N.FieldDecl]:
        decls = []
        for e in self._gen_rhs_entries:
            # dedicated rhs of a coupled entry: zero at the finest
            # (the normalized equation is `... - v == 0`), receives the
            # restricted residual on coarser levels
            decls.append(
                N.FieldDecl(e.rhs, "global", f"__loc_{e.localization}__",
                            bc=None, levels=None)
            )
        for e in self.spec.entries:
            rf = self.res_field(e)
            decls.append(
                N.FieldDecl(rf, "global", f"__loc_{e.localization}__",
                            bc=N.Num(0.0), levels=None)
            )
            if self.jacobi_type:
                decls.append(
                    N.FieldDecl(f"gen_tmp{self._suffix(e)}", "global",
                                f"__loc_{e.localization}__", bc=None, levels=None)
                )
            if self.use_fas:
                decls.append(
                    N.FieldDecl(f"gen_approx{self._suffix(e)}", "global",
                                f"__loc_{e.localization}__", bc=N.Num(0.0),
                                levels=_ALL_BUT_FINEST)
                )
            for tmp in self._cgs_tmp_fields(e):
                decls.append(
                    N.FieldDecl(tmp, "global", f"__loc_{e.localization}__",
                                bc=N.Num(0.0), levels=_COARSEST)
                )
        return decls

    def _cgs_tmp_fields(self, e: EqEntry) -> List[str]:
        sfx = self._suffix(e)
        return {
            "CG": [f"gen_cgTmp0{sfx}", f"gen_cgTmp1{sfx}"],
            "BiCGStab": [f"gen_nu{sfx}", f"gen_p{sfx}", f"gen_h{sfx}", f"gen_s{sfx}",
                         f"gen_t{sfx}", f"gen_resHat{sfx}"],
            "MinRes": [f"gen_pOld{sfx}", f"gen_p{sfx}", f"gen_pNew{sfx}",
                       f"gen_vOld{sfx}", f"gen_v{sfx}", f"gen_vNew{sfx}"],
            "CR": [f"gen_p{sfx}", f"gen_ap{sfx}", f"gen_ar{sfx}"],
            "Smoother": [],
        }[self.cgs]

    def transfer_decls(self) -> List[N.StencilFromDefault]:
        # restriction of integral residuals (FV/FE) sums instead of
        # averages (L3_SolverForEquation.defInterpolationForRestriction)
        discr = str(getattr(self.k, "discr_type", "FiniteDifferences")).lower()
        res_interp = ("integral_linear"
                      if discr in ("fv", "finitevolume", "finitevolumes",
                                   "fe", "finiteelement", "finiteelements")
                      else "linear")
        decls, seen = [], set()
        for e in self.spec.entries:
            loc = e.localization
            if loc in seen:
                continue
            seen.add(loc)
            decls.append(N.StencilFromDefault(
                f"gen_restriction_{loc}", "restriction", loc, res_interp))
            decls.append(N.StencilFromDefault(
                f"gen_prolongation_{loc}", "prolongation", loc, "linear"))
        return decls

    # -------------------------------------------------- expression pieces
    def _residual_expr(self, e: EqEntry, level=None) -> N.Expr:
        """rhs - sum(op * field)."""
        expr: N.Expr = acc(e.rhs, level)
        for t in e.terms:
            prod = binop("*", acc(t.operator, level), acc(t.field, level))
            if t.coef is not None:
                prod = binop("*", t.coef, prod)
            expr = binop("-", expr, prod)
        return expr

    def _compute_residual(self, e: EqEntry, level=None) -> List[N.Stmt]:
        rf = self.res_field(e)
        return [
            N.Communicate(acc(e.unknown, level)),
            loop_over(acc(rf, level), [assign(acc(rf, level), "=", self._residual_expr(e, level))]),
            N.ApplyBC(acc(rf, level)),
        ]

    def _res_norm_fn(self) -> N.FunctionDecl:
        """ResNorm over all equations' residuals (L3_SolverForEqEntry.genResNormFn)."""
        body: List[N.Stmt] = [var("gen_resNorm", "Real", num(0.0))]
        for e in self.spec.entries:
            rf = self.res_field(e)
            body.append(
                loop_over(acc(rf), [assign(acc("gen_resNorm"), "+=",
                                           binop("*", acc(rf), acc(rf)))],
                          reduction=("+", "gen_resNorm"))
            )
        body.append(N.Return(call("sqrt", acc("gen_resNorm"))))
        return N.FunctionDecl("gen_resNorm", N.LvlAll(), [], "Real", body)

    # -------------------------------------------------- smoother
    def _diag_expr(self, e: EqEntry) -> N.Expr:
        """Sum of coef*diag(op) over the unknown's own terms — the
        point-diagonal of the (possibly multi-term) operator."""
        parts = []
        for t in e.terms:
            if t.field != e.unknown:
                continue
            d = call("diag", acc(t.operator))
            if t.coef is not None:
                d = binop("*", t.coef, d)
            parts.append(d)
        if not parts:
            raise ValueError(f"no diagonal term for unknown {e.unknown}")
        expr = parts[0]
        for p in parts[1:]:
            expr = binop("+", expr, p)
        return expr

    def _smoother_update(self, e: EqEntry) -> N.Expr:
        """damping / diag * (rhs - sum coef*op*field)."""
        upd = self._residual_expr(e)
        dinv = binop("/", num(self.damping), self._diag_expr(e))
        return binop("*", dinv, upd)

    def _color_expr(self) -> Optional[N.Expr]:
        c = self.coloring
        if c in ("None", "none", ""):
            return None
        idx = [acc(f"i{d}") for d in range(self.ndim)]
        if c in ("red-black", "rb", "2-way"):
            s = idx[0]
            for i in idx[1:]:
                s = binop("+", s, i)
            return binop("%", s, N.Num(2, True))
        if c in ("9-way", "27-way", "3-way"):
            # per-dim mod-3 coloring (L3 coloring variants)
            s = binop("%", idx[0], N.Num(3, True))
            mult = 3
            for i in idx[1:]:
                s = binop("+", s, binop("*", N.Num(mult, True), binop("%", i, N.Num(3, True))))
                mult *= 3
            return binop("%", s, N.Num(3 ** self.ndim, True))
        raise ValueError(f"unsupported coloring {c!r}")

    def _smoother_sweep(self) -> List[N.Stmt]:
        """One full smoother sweep over all equations."""
        color = self._color_expr()
        stmts: List[N.Stmt] = []
        if self.jacobi_type:
            # u_tmp = u + upd; u = u_tmp (slot-free Jacobi equivalent of
            # the reference's <next>/advance mechanics)
            for e in self.spec.entries:
                tmp = f"gen_tmp{self._suffix(e)}"
                stmts.append(N.Communicate(acc(e.unknown)))
                stmts.append(loop_over(acc(tmp), [
                    assign(acc(tmp), "=", binop("+", acc(e.unknown), self._smoother_update(e)))
                ]))
            for e in self.spec.entries:
                tmp = f"gen_tmp{self._suffix(e)}"
                stmts.append(loop_over(acc(e.unknown), [
                    assign(acc(e.unknown), "=", acc(tmp))
                ]))
                stmts.append(N.ApplyBC(acc(e.unknown)))
            return stmts
        if color is None:
            # lexicographic Gauss-Seidel: sequential loop (wavefront exec)
            for e in self.spec.entries:
                stmts.append(N.Communicate(acc(e.unknown)))
                stmts.append(loop_over(
                    acc(e.unknown),
                    [assign(acc(e.unknown), "+=", self._smoother_update(e))],
                    sequentially=True,
                ))
                stmts.append(N.ApplyBC(acc(e.unknown)))
            return stmts
        inner: List[N.Stmt] = []
        for e in self.spec.entries:
            inner.append(N.Communicate(acc(e.unknown)))
            inner.append(loop_over(acc(e.unknown), [
                assign(acc(e.unknown), "+=", self._smoother_update(e))
            ]))
            inner.append(N.ApplyBC(acc(e.unknown)))
        stmts.append(N.ColorWith(color, inner))
        return stmts

    def _smoother_block(self, n: int) -> List[N.Stmt]:
        if n <= 0:
            return []
        sweep = self._smoother_sweep()
        mods = self._collect_mods("smoother")
        for action, lvls, stmts in mods:
            sweep = self._apply_mod(sweep, action, lvls, stmts)
        return [N.RepeatTimes(N.Num(n, True), sweep)]

    # -------------------------------------------------- cycle
    def cycle_fn(self) -> N.FunctionDecl:
        body: List[N.Stmt] = []
        body += self._smoother_block(self.num_pre)
        for e in self.spec.entries:
            body += self._compute_residual(e)
        # restriction
        for e in self.spec.entries:
            rf = self.res_field(e)
            R = f"gen_restriction_{e.localization}"
            body.append(N.Communicate(acc(rf)))
            if self.use_fas:
                # FAS: RHS@coarser = R*res + A@coarser * (R*u)
                # (solver/l3/L3_SolverForEquation.scala:401-452)
                appr = f"gen_approx{self._suffix(e)}"
                body.append(N.Communicate(acc(e.unknown)))
                body.append(loop_over(acc(appr, _COARSER), [
                    assign(acc(appr, _COARSER), "=", binop("*", acc(R), acc(e.unknown)))
                ]))
                body.append(N.ApplyBC(acc(appr, _COARSER)))
                coarse_lhs: N.Expr = binop("*", acc(R), acc(rf))
                for t in e.terms:
                    src = acc(t.field, _COARSER) if t.field != e.unknown else acc(appr, _COARSER)
                    prod = binop("*", acc(t.operator, _COARSER), src)
                    if t.coef is not None:
                        prod = binop("*", t.coef, prod)
                    coarse_lhs = binop("+", coarse_lhs, prod)
                body.append(loop_over(acc(e.rhs, _COARSER), [
                    assign(acc(e.rhs, _COARSER), "=", coarse_lhs)
                ]))
            else:
                body.append(loop_over(acc(e.rhs, _COARSER), [
                    assign(acc(e.rhs, _COARSER), "=", binop("*", acc(R), acc(rf)))
                ]))
        # init coarse solution
        for e in self.spec.entries:
            if self.use_fas:
                appr = f"gen_approx{self._suffix(e)}"
                body.append(loop_over(acc(e.unknown, _COARSER), [
                    assign(acc(e.unknown, _COARSER), "=", acc(appr, _COARSER))
                ]))
            else:
                body.append(loop_over(acc(e.unknown, _COARSER), [
                    assign(acc(e.unknown, _COARSER), "=", num(0.0))
                ]))
            body.append(N.ApplyBC(acc(e.unknown, _COARSER)))
        body.append(N.ExprStmt(call("gen_mgCycle", level=_COARSER)))
        # prolongation / correction
        for e in self.spec.entries:
            P = f"gen_prolongation_{e.localization}"
            body.append(N.Communicate(acc(e.unknown, _COARSER)))
            if self.use_fas:
                appr = f"gen_approx{self._suffix(e)}"
                body.append(loop_over(acc(e.unknown), [
                    assign(acc(e.unknown), "+=",
                           binop("*", acc(P, _COARSER),
                                 binop("-", acc(e.unknown, _COARSER), acc(appr, _COARSER))))
                ]))
            else:
                body.append(loop_over(acc(e.unknown), [
                    assign(acc(e.unknown), "+=",
                           binop("*", acc(P, _COARSER), acc(e.unknown, _COARSER)))
                ]))
            body.append(N.ApplyBC(acc(e.unknown)))
        body += self._smoother_block(self.num_post)
        for action, lvls, stmts in self._collect_mods("cycle"):
            body = self._apply_mod(body, action, lvls, stmts)
        return N.FunctionDecl("gen_mgCycle", _ALL_BUT_COARSEST, [], "Unit", body)

    # -------------------------------------------------- coarse-grid solver
    def cgs_fn(self) -> N.FunctionDecl:
        if self.cgs == "Smoother":
            body = self._smoother_block(max(1, self.cgs_max_its))
        else:
            builder = {
                "CG": self._cg_body,
                "BiCGStab": self._bicgstab_body,
                "MinRes": self._minres_body,
                "CR": self._cr_body,
            }[self.cgs]
            body = builder()
        for action, lvls, stmts in self._collect_mods("cgs"):
            body = self._apply_mod(body, action, lvls, stmts)
        return N.FunctionDecl("gen_mgCycle", _COARSEST, [], "Unit", body)

    def _cgs_converged(self, next_res: N.Expr) -> N.Expr:
        cond: N.Expr = binop("<=", next_res, binop("*", num(self.cgs_target_res), acc("gen_initRes")))
        if self.cgs_abs_res > 0:
            cond = binop("||", cond, binop("<=", next_res, num(self.cgs_abs_res)))
        return cond

    def _cgs_prelude(self) -> List[N.Stmt]:
        body: List[N.Stmt] = []
        for e in self.spec.entries:
            body += self._compute_residual(e)
        body += [
            var("gen_curRes", "Real", call("gen_resNorm")),
            var("gen_initRes", "Real", acc("gen_curRes")),
            N.If(binop("==", acc("gen_curRes"), num(0.0)), [N.Return()], []),
        ]
        return body

    def _cgs_exceeded(self) -> List[N.Stmt]:
        if self.silent:
            return []
        return [N.ExprStmt(call(
            "print", N.Str("Maximum number of cgs iterations ("),
            N.Num(self.cgs_max_its, True), N.Str(") was exceeded")))]

    def _field_assign_all(self, dst_of, src_of, op="=", bc=True) -> List[N.Stmt]:
        out = []
        for e in self.spec.entries:
            dst, src = dst_of(e), src_of(e)
            out.append(loop_over(dst, [assign(dst, op, src)]))
            if bc:
                out.append(N.ApplyBC(dst))
        return out

    def _dot_all(self, out_var: str, a_of, b_of) -> List[N.Stmt]:
        """out = sum over entries of dot(a, b) via reduction loops."""
        stmts: List[N.Stmt] = [var(out_var, "Real", num(0.0))]
        for e in self.spec.entries:
            a, b = a_of(e), b_of(e)
            stmts.append(loop_over(a, [assign(acc(out_var), "+=", binop("*", a, b))],
                                   reduction=("+", out_var)))
        return stmts

    def _apply_op_all(self, dst_of, src_of) -> List[N.Stmt]:
        """dst_i = (sum_j op_ij * src-substituted field_j) for each eq:
        apply the full block operator with unknown fields substituted by
        the src vector fields."""
        out = []
        for e in self.spec.entries:
            dst = dst_of(e)
            expr = None
            for t in e.terms:
                term = binop("*", acc(t.operator), self._subst_vec(t.field, src_of))
                if t.coef is not None:
                    term = binop("*", t.coef, term)
                expr = term if expr is None else binop("+", expr, term)
            out.append(N.Communicate(self._subst_vec(e.unknown, src_of)))
            out.append(loop_over(dst, [assign(dst, "=", expr)]))
        return out

    def _subst_vec(self, field_name: str, src_of):
        """Map a lhs field to its Krylov-vector stand-in (same index for
        the unknown it represents)."""
        for e in self.spec.entries:
            if e.unknown == field_name:
                return src_of(e)
        return acc(field_name)

    def _cg_body(self) -> List[N.Stmt]:
        sfx = self._suffix
        body = self._cgs_prelude()
        body += self._field_assign_all(
            lambda e: acc(f"gen_cgTmp0{sfx(e)}"), lambda e: acc(self.res_field(e)))
        body.append(var("gen_curStep", "Integer", N.Num(0, True)))
        loop_body: List[N.Stmt] = []
        loop_body += self._apply_op_all(
            lambda e: acc(f"gen_cgTmp1{sfx(e)}"), lambda e: acc(f"gen_cgTmp0{sfx(e)}"))
        loop_body += self._dot_all("gen_alphaNom",
                                   lambda e: acc(self.res_field(e)),
                                   lambda e: acc(self.res_field(e)))
        loop_body += self._dot_all("gen_alphaDenom",
                                   lambda e: acc(f"gen_cgTmp0{sfx(e)}"),
                                   lambda e: acc(f"gen_cgTmp1{sfx(e)}"))
        loop_body.append(var("gen_alpha", "Real",
                             binop("/", acc("gen_alphaNom"), acc("gen_alphaDenom"))))
        loop_body += self._field_assign_all(
            lambda e: acc(e.unknown),
            lambda e: binop("*", acc("gen_alpha"), acc(f"gen_cgTmp0{sfx(e)}")), op="+=")
        loop_body += self._field_assign_all(
            lambda e: acc(self.res_field(e)),
            lambda e: binop("*", acc("gen_alpha"), acc(f"gen_cgTmp1{sfx(e)}")), op="-=")
        loop_body.append(var("gen_nextRes", "Real", call("gen_resNorm")))
        loop_body.append(N.If(self._cgs_converged(acc("gen_nextRes")), [N.Return()], []))
        loop_body.append(var("gen_beta", "Real",
                             binop("/", binop("*", acc("gen_nextRes"), acc("gen_nextRes")),
                                   binop("*", acc("gen_curRes"), acc("gen_curRes")))))
        loop_body += self._field_assign_all(
            lambda e: acc(f"gen_cgTmp0{sfx(e)}"),
            lambda e: binop("+", acc(self.res_field(e)),
                            binop("*", acc("gen_beta"), acc(f"gen_cgTmp0{sfx(e)}"))))
        loop_body.append(assign(acc("gen_curRes"), "=", acc("gen_nextRes")))
        body.append(N.RepeatTimes(N.Num(self.cgs_max_its, True), loop_body,
                                  count_var="gen_curStep"))
        body += self._cgs_exceeded()
        return body

    def _bicgstab_body(self) -> List[N.Stmt]:
        sfx = self._suffix
        body = self._cgs_prelude()
        body += [
            var("gen_alpha", "Real", num(1.0)),
            var("gen_beta", "Real", num(1.0)),
            var("gen_rho", "Real", num(0.0)),
            var("gen_rhoNew", "Real", num(1.0)),
            var("gen_omega", "Real", num(1.0)),
        ]
        body += self._field_assign_all(
            lambda e: acc(f"gen_resHat{sfx(e)}"), lambda e: acc(self.res_field(e)))
        body += self._field_assign_all(lambda e: acc(f"gen_nu{sfx(e)}"), lambda e: num(0.0))
        body += self._field_assign_all(lambda e: acc(f"gen_p{sfx(e)}"), lambda e: num(0.0))
        body.append(var("gen_curStep", "Integer", N.Num(0, True)))

        loop_body: List[N.Stmt] = [assign(acc("gen_rho"), "=", acc("gen_rhoNew"))]
        loop_body += self._dot_all("gen_rhoNewTmp",
                                   lambda e: acc(f"gen_resHat{sfx(e)}"),
                                   lambda e: acc(self.res_field(e)))
        loop_body.append(assign(acc("gen_rhoNew"), "=", acc("gen_rhoNewTmp")))
        loop_body.append(assign(acc("gen_beta"), "=",
                                binop("*", binop("/", acc("gen_rhoNew"), acc("gen_rho")),
                                      binop("/", acc("gen_alpha"), acc("gen_omega")))))
        loop_body += self._field_assign_all(
            lambda e: acc(f"gen_p{sfx(e)}"),
            lambda e: binop("+", acc(self.res_field(e)),
                            binop("*", acc("gen_beta"),
                                  binop("-", acc(f"gen_p{sfx(e)}"),
                                        binop("*", acc("gen_omega"), acc(f"gen_nu{sfx(e)}"))))))
        loop_body += self._apply_op_all(
            lambda e: acc(f"gen_nu{sfx(e)}"), lambda e: acc(f"gen_p{sfx(e)}"))
        loop_body += self._dot_all("gen_alphaDenom",
                                   lambda e: acc(f"gen_resHat{sfx(e)}"),
                                   lambda e: acc(f"gen_nu{sfx(e)}"))
        loop_body.append(assign(acc("gen_alpha"), "=",
                                binop("/", acc("gen_rhoNew"), acc("gen_alphaDenom"))))
        loop_body += self._field_assign_all(
            lambda e: acc(f"gen_h{sfx(e)}"),
            lambda e: binop("+", acc(e.unknown),
                            binop("*", acc("gen_alpha"), acc(f"gen_p{sfx(e)}"))))
        loop_body += self._field_assign_all(
            lambda e: acc(f"gen_s{sfx(e)}"),
            lambda e: binop("-", acc(self.res_field(e)),
                            binop("*", acc("gen_alpha"), acc(f"gen_nu{sfx(e)}"))))
        loop_body += self._apply_op_all(
            lambda e: acc(f"gen_t{sfx(e)}"), lambda e: acc(f"gen_s{sfx(e)}"))
        loop_body += self._dot_all("gen_omegaNom",
                                   lambda e: acc(f"gen_t{sfx(e)}"),
                                   lambda e: acc(f"gen_s{sfx(e)}"))
        loop_body += self._dot_all("gen_omegaDenom",
                                   lambda e: acc(f"gen_t{sfx(e)}"),
                                   lambda e: acc(f"gen_t{sfx(e)}"))
        loop_body.append(assign(acc("gen_omega"), "=",
                                binop("/", acc("gen_omegaNom"), acc("gen_omegaDenom"))))
        loop_body += self._field_assign_all(
            lambda e: acc(e.unknown),
            lambda e: binop("+", acc(f"gen_h{sfx(e)}"),
                            binop("*", acc("gen_omega"), acc(f"gen_s{sfx(e)}"))))
        loop_body += self._field_assign_all(
            lambda e: acc(self.res_field(e)),
            lambda e: binop("-", acc(f"gen_s{sfx(e)}"),
                            binop("*", acc("gen_omega"), acc(f"gen_t{sfx(e)}"))))
        loop_body.append(assign(acc("gen_curRes"), "=", call("gen_resNorm")))
        loop_body.append(N.If(self._cgs_converged(acc("gen_curRes")), [N.Return()], []))

        if self.cgs_restart and self.cgs_restart_after < self.cgs_max_its:
            n_restarts = max(1, self.cgs_max_its // self.cgs_restart_after)
            restart_round = [N.RepeatTimes(N.Num(self.cgs_restart_after, True), loop_body,
                                           count_var="gen_curStep")]
            # re-init residual + vectors between rounds (solver_cgs_restart)
            reinit: List[N.Stmt] = []
            for e in self.spec.entries:
                reinit += self._compute_residual(e)
            reinit += self._field_assign_all(
                lambda e: acc(f"gen_resHat{sfx(e)}"), lambda e: acc(self.res_field(e)))
            reinit += self._field_assign_all(lambda e: acc(f"gen_nu{sfx(e)}"), lambda e: num(0.0))
            reinit += self._field_assign_all(lambda e: acc(f"gen_p{sfx(e)}"), lambda e: num(0.0))
            reinit += [
                assign(acc("gen_alpha"), "=", num(1.0)),
                assign(acc("gen_beta"), "=", num(1.0)),
                assign(acc("gen_rhoNew"), "=", num(1.0)),
                assign(acc("gen_omega"), "=", num(1.0)),
            ]
            body.append(N.RepeatTimes(N.Num(n_restarts, True), restart_round + reinit))
        else:
            body.append(N.RepeatTimes(N.Num(self.cgs_max_its, True), loop_body,
                                      count_var="gen_curStep"))
        body += self._cgs_exceeded()
        return body

    def _minres_body(self) -> List[N.Stmt]:
        sfx = self._suffix
        body = self._cgs_prelude()
        body += [
            var("gen_alpha", "Real", num(0.0)),
            var("gen_betaOld", "Real", num(0.0)),
            var("gen_betaNew", "Real", num(0.0)),
            var("gen_cOld", "Real", num(1.0)),
            var("gen_c", "Real", num(1.0)),
            var("gen_cNew", "Real", num(1.0)),
            var("gen_sOld", "Real", num(0.0)),
            var("gen_s", "Real", num(0.0)),
            var("gen_sNew", "Real", num(0.0)),
        ]
        body += self._field_assign_all(lambda e: acc(f"gen_v{sfx(e)}"), lambda e: num(0.0))
        body += self._field_assign_all(
            lambda e: acc(f"gen_vNew{sfx(e)}"),
            lambda e: binop("/", acc(self.res_field(e)), acc("gen_initRes")))
        body += self._field_assign_all(lambda e: acc(f"gen_p{sfx(e)}"), lambda e: num(0.0))
        body += self._field_assign_all(lambda e: acc(f"gen_pNew{sfx(e)}"), lambda e: num(0.0))
        body.append(var("gen_curStep", "Integer", N.Num(0, True)))

        lb: List[N.Stmt] = [var("gen_beta", "Real", acc("gen_betaNew"))]
        lb += self._field_assign_all(
            lambda e: acc(f"gen_vOld{sfx(e)}"), lambda e: acc(f"gen_v{sfx(e)}"))
        lb += self._field_assign_all(
            lambda e: acc(f"gen_v{sfx(e)}"), lambda e: acc(f"gen_vNew{sfx(e)}"))
        lb += self._apply_op_all(
            lambda e: acc(f"gen_vNew{sfx(e)}"), lambda e: acc(f"gen_v{sfx(e)}"))
        lb += self._field_assign_all(
            lambda e: acc(f"gen_vNew{sfx(e)}"),
            lambda e: binop("*", acc("gen_beta"), acc(f"gen_vOld{sfx(e)}")), op="-=")
        lb += self._dot_all("gen_alphaTmp",
                            lambda e: acc(f"gen_vNew{sfx(e)}"),
                            lambda e: acc(f"gen_v{sfx(e)}"))
        lb.append(assign(acc("gen_alpha"), "=", acc("gen_alphaTmp")))
        lb += self._field_assign_all(
            lambda e: acc(f"gen_vNew{sfx(e)}"),
            lambda e: binop("*", acc("gen_alpha"), acc(f"gen_v{sfx(e)}")), op="-=")
        lb += self._dot_all("gen_betaSq",
                            lambda e: acc(f"gen_vNew{sfx(e)}"),
                            lambda e: acc(f"gen_vNew{sfx(e)}"))
        lb.append(assign(acc("gen_betaNew"), "=", call("sqrt", acc("gen_betaSq"))))
        lb += self._field_assign_all(
            lambda e: acc(f"gen_vNew{sfx(e)}"), lambda e: acc("gen_betaNew"), op="/=")
        lb += [
            assign(acc("gen_cOld"), "=", acc("gen_c")),
            assign(acc("gen_c"), "=", acc("gen_cNew")),
            assign(acc("gen_sOld"), "=", acc("gen_s")),
            assign(acc("gen_s"), "=", acc("gen_sNew")),
            var("gen_rho1", "Real", binop("*", acc("gen_sOld"), acc("gen_beta"))),
            var("gen_rho2", "Real",
                binop("+", binop("*", binop("*", acc("gen_c"), acc("gen_cOld")), acc("gen_beta")),
                      binop("*", acc("gen_s"), acc("gen_alpha")))),
            var("gen_rho3Tld", "Real",
                binop("-", binop("*", acc("gen_c"), acc("gen_alpha")),
                      binop("*", binop("*", acc("gen_s"), acc("gen_cOld")), acc("gen_beta")))),
            var("gen_tau", "Real",
                binop("+", call("fabs", acc("gen_rho3Tld")), call("fabs", acc("gen_betaNew")))),
            var("gen_nu", "Real",
                binop("*", acc("gen_tau"),
                      call("sqrt", binop("+",
                                         binop("**", binop("/", acc("gen_rho3Tld"), acc("gen_tau")), num(2.0)),
                                         binop("**", binop("/", acc("gen_betaNew"), acc("gen_tau")), num(2.0)))))),
            assign(acc("gen_cNew"), "=", binop("/", acc("gen_rho3Tld"), acc("gen_nu"))),
            assign(acc("gen_sNew"), "=", binop("/", acc("gen_betaNew"), acc("gen_nu"))),
            var("gen_rho3", "Real", acc("gen_nu")),
        ]
        lb += self._field_assign_all(
            lambda e: acc(f"gen_pOld{sfx(e)}"), lambda e: acc(f"gen_p{sfx(e)}"))
        lb += self._field_assign_all(
            lambda e: acc(f"gen_p{sfx(e)}"), lambda e: acc(f"gen_pNew{sfx(e)}"))
        lb += self._field_assign_all(
            lambda e: acc(f"gen_pNew{sfx(e)}"),
            lambda e: binop("/", binop("-", binop("-", acc(f"gen_v{sfx(e)}"),
                                                  binop("*", acc("gen_rho1"), acc(f"gen_pOld{sfx(e)}"))),
                                       binop("*", acc("gen_rho2"), acc(f"gen_p{sfx(e)}"))),
                            acc("gen_rho3")))
        lb += self._field_assign_all(
            lambda e: acc(e.unknown),
            lambda e: binop("*", binop("*", acc("gen_cNew"), acc("gen_curRes")),
                            acc(f"gen_pNew{sfx(e)}")), op="+=")
        lb.append(assign(acc("gen_curRes"), "*=", N.UnOp("-", acc("gen_sNew"))))
        lb.append(N.If(self._cgs_converged(call("fabs", acc("gen_curRes"))), [N.Return()], []))
        body.append(N.RepeatTimes(N.Num(self.cgs_max_its, True), lb, count_var="gen_curStep"))
        body += self._cgs_exceeded()
        return body

    def _cr_body(self) -> List[N.Stmt]:
        sfx = self._suffix
        body = self._cgs_prelude()
        body += self._field_assign_all(
            lambda e: acc(f"gen_p{sfx(e)}"), lambda e: acc(self.res_field(e)))
        body += self._apply_op_all(
            lambda e: acc(f"gen_ap{sfx(e)}"), lambda e: acc(f"gen_p{sfx(e)}"))
        body += self._apply_op_all(
            lambda e: acc(f"gen_ar{sfx(e)}"), lambda e: acc(self.res_field(e)))
        body.append(var("gen_curStep", "Integer", N.Num(0, True)))
        lb: List[N.Stmt] = []
        lb += self._dot_all("gen_rAr",
                            lambda e: acc(self.res_field(e)),
                            lambda e: acc(f"gen_ar{sfx(e)}"))
        lb += self._dot_all("gen_apAp",
                            lambda e: acc(f"gen_ap{sfx(e)}"),
                            lambda e: acc(f"gen_ap{sfx(e)}"))
        lb.append(var("gen_alpha", "Real", binop("/", acc("gen_rAr"), acc("gen_apAp"))))
        lb += self._field_assign_all(
            lambda e: acc(e.unknown),
            lambda e: binop("*", acc("gen_alpha"), acc(f"gen_p{sfx(e)}")), op="+=")
        lb += self._field_assign_all(
            lambda e: acc(self.res_field(e)),
            lambda e: binop("*", acc("gen_alpha"), acc(f"gen_ap{sfx(e)}")), op="-=")
        lb.append(var("gen_nextRes", "Real", call("gen_resNorm")))
        lb.append(N.If(self._cgs_converged(acc("gen_nextRes")), [N.Return()], []))
        lb += self._apply_op_all(
            lambda e: acc(f"gen_ar{sfx(e)}"), lambda e: acc(self.res_field(e)))
        lb += self._dot_all("gen_rArNew",
                            lambda e: acc(self.res_field(e)),
                            lambda e: acc(f"gen_ar{sfx(e)}"))
        lb.append(var("gen_beta", "Real", binop("/", acc("gen_rArNew"), acc("gen_rAr"))))
        lb += self._field_assign_all(
            lambda e: acc(f"gen_p{sfx(e)}"),
            lambda e: binop("+", acc(self.res_field(e)),
                            binop("*", acc("gen_beta"), acc(f"gen_p{sfx(e)}"))))
        lb += self._field_assign_all(
            lambda e: acc(f"gen_ap{sfx(e)}"),
            lambda e: binop("+", acc(f"gen_ar{sfx(e)}"),
                            binop("*", acc("gen_beta"), acc(f"gen_ap{sfx(e)}"))))
        lb.append(assign(acc("gen_curRes"), "=", acc("gen_nextRes")))
        body.append(N.RepeatTimes(N.Num(self.cgs_max_its, True), lb, count_var="gen_curStep"))
        body += self._cgs_exceeded()
        return body

    # -------------------------------------------------- solve driver
    def solve_fn(self) -> N.FunctionDecl:
        body: List[N.Stmt] = []
        for e in self.spec.entries:
            body += self._compute_residual(e, _FINEST)
        body += [
            var("gen_initRes", "Real", call("gen_resNorm", level=_FINEST)),
            var("gen_curRes", "Real", acc("gen_initRes")),
            var("gen_prevRes", "Real", acc("gen_curRes")),
        ]
        if not self.silent:
            body += _testing_print(acc("gen_initRes"), "testing_printRes")
            body.append(_print_nontesting([N.Str("Starting residual: "), acc("gen_initRes")]))
        stop: N.Expr = binop("||",
                             binop(">=", acc("gen_curIt"), N.Num(self.max_its, True)),
                             binop("<=", acc("gen_curRes"),
                                   binop("*", num(self.target_res), acc("gen_initRes"))))
        if self.abs_res > 0:
            stop = binop("||", stop, binop("<=", acc("gen_curRes"), num(self.abs_res)))
        iter_body: List[N.Stmt] = [
            assign(acc("gen_curIt"), "+=", N.Num(1, True)),
            N.ExprStmt(call("gen_mgCycle", level=_FINEST)),
        ]
        for e in self.spec.entries:
            iter_body += self._compute_residual(e, _FINEST)
        iter_body += [
            assign(acc("gen_prevRes"), "=", acc("gen_curRes")),
            assign(acc("gen_curRes"), "=", call("gen_resNorm", level=_FINEST)),
        ]
        if not self.silent:
            iter_body += _testing_print(acc("gen_curRes"), "testing_printRes")
            iter_body.append(_print_nontesting([
                N.Str("Residual after"), acc("gen_curIt"), N.Str("iterations is"),
                acc("gen_curRes"), N.Str("--- convergence factor is"),
                binop("/", acc("gen_curRes"), acc("gen_prevRes"))]))
        body.append(var("gen_curIt", "Int", N.Num(0, True)))
        body.append(N.RepeatUntil(stop, iter_body))
        for action, lvls, stmts in self._collect_mods("solver"):
            body = self._apply_mod(body, action, lvls, stmts)
        return N.FunctionDecl("gen_solve", _FINEST, [], "Unit", body)

    # -------------------------------------------------- modifiers
    def _collect_mods(self, target: str):
        return [(a, lv, st) for (a, tgt, lv, st) in self.spec.modifiers if tgt == target]

    @staticmethod
    def _apply_mod(body: List[N.Stmt], action: str, levels, stmts: List[N.Stmt]):
        wrapped = [N.LevelScope(levels, stmts)] if levels is not None else list(stmts)
        if action == "append":
            return body + wrapped
        if action == "prepend":
            return wrapped + body
        if action == "replace":
            return wrapped
        raise ValueError(f"unknown modifier action {action!r}")

    # -------------------------------------------------- assembly
    def generate(self) -> N.Program:
        prog = N.Program()
        prog.fields = self.field_decls()
        prog.stencils = self._extra_stencils + self.transfer_decls()
        prog.functions = [
            self._res_norm_fn(),
            self.cycle_fn(),
            self.cgs_fn(),
            self.solve_fn(),
        ]
        return prog


def default_application(init_field_stmts: List[N.Stmt],
                        solve_name: str = "gen_solve") -> N.FunctionDecl:
    """The default Application wrapper
    (applications/l4/L4_AddDefaultApplication.scala)."""
    body: List[N.Stmt] = [
        N.ExprStmt(call("startTimer", N.Str("setup"))),
        N.ExprStmt(call("initGlobals")),
        N.ExprStmt(call("initDomain")),
        N.ExprStmt(call("initFieldsWithZero")),
        N.ExprStmt(call("initGeometry")),
    ]
    body += init_field_stmts
    body += [
        N.ExprStmt(call("stopTimer", N.Str("setup"))),
        N.ExprStmt(call("startTimer", N.Str("solve"))),
        N.ExprStmt(call(solve_name, level=_FINEST)),
        N.ExprStmt(call("stopTimer", N.Str("solve"))),
        N.If(N.UnOp("!", call("getKnowledge", N.Str("testing_enabled"))),
             [N.ExprStmt(call("printAllTimers"))], []),
        N.ExprStmt(call("destroyGlobals")),
    ]
    return N.FunctionDecl("Application", None, [], "Unit", body)
