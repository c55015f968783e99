"""L4 -> CUDA fast path: pattern compilation of DSL programs.

Reference: exastencils_tpu/dsl/fastpath.py.  The same matchers, planner
and liveness-gated dead-store elision; the segments call the port's
kernel makers (ops/cuda): `make_fused_legs_3d` gives the whole-leg
kernels K1/K2 (K7/K8 under EXA_STREAM_V1=1), `make_fused_smoother_3d`
the fused smoother K3 (K6).  The path is on where the executable's
device is CUDA; EXA_FASTPATH_FORCE=1 forces it on the CPU (the wrappers
then run their plain versions) and lowers the level threshold from 33
to 5 nodes per dimension, as in the reference.

K1-K3 update the iterate in place.  A segment therefore takes the
iterate through `exe.own_field`, which clones it first if any other
state entry, frame variable or global holds the same storage, so no
other name can see the update.

Recognized shapes (the `generate solver` output and the hand-written
Examples/Benchmark programs both take exactly these forms):

  smoother      repeat N times { color with { (i0+i1+i2)%2,
                  [communicate u], loop over u { u += (w/diag(A)) *
                  (f - A*u) }, [apply bc to u] } }
                (directly, or as a call to a function with that body)

  down leg      <smoother call>; <calcres call>; [communicate res];
                loop over rhs@coarser { rhs@coarser = R * res }
                where <calcres> = [communicate u]; loop over res
                { res = f - A*u }; [apply bc to res]

  up leg        [communicate u@coarser];
                loop over u { u += P * u@coarser }; [apply bc to u];
                <smoother call>

The down leg elides the residual store entirely (one streaming pass:
smooth + residual + restrict).  That is a cross-statement dead-store
elimination and is only performed when dsl/liveness.py PROVES the
residual's interior is overwritten before any read on every program
continuation.  When proof fails, only the smoother is fused (always
sound: it writes exactly what the source loop writes).

Correctness envelope (checked per match):
  dense backend only (mesh=None), 3D, scalar node fields with one slot,
  constant radius-1 star stencil, homogeneous Dirichlet bc on u/res
  (the kernels preserve the boundary ring, which the plain path's
  interior-masked loops also never write), separable 2:1 transfers in
  the supported z-geometries.  Everything else executes on the plain
  torch ops of the interpreter.

Externally visible difference (documented): a residual field elided as
a dead store is re-materialized on `get_field` as the residual of the
*current* iterate; raw `.state` peeks between cycles may see the stale
previous-cycle array.  No in-program read can observe this (liveness
proof), and goldens print residuals computed by explicit CalcRes calls.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from exastencils_tpu_torch.dsl import nodes as N

from exastencils_tpu_torch.core.field import DirichletBC, Field
from exastencils_tpu_torch.core.grid import NODE
from exastencils_tpu_torch.core.stencil import BoundStencil, IntergridStencil
from exastencils_tpu_torch.dsl.liveness import FieldLiveness
from exastencils_tpu_torch.ops.cuda import (
    cuda_applicable_3d,
    make_fused_legs_3d,
    make_fused_smoother_3d,
)


def _forced() -> bool:
    return os.environ.get("EXA_FASTPATH_FORCE") == "1"


def fastpath_enabled(exe) -> bool:
    """`tpu_dsl_fastpath` and `tpu_use_pallas` (read as "use the
    hand-written kernels"), a 3D program, and a CUDA device (or
    EXA_FASTPATH_FORCE=1 on the CPU, for parity tests); dense runs only,
    as the reference's (a sharded run has no whole-grid array to hand a
    kernel)."""
    k = exe.k
    if getattr(exe, "frag", None) is not None:
        return False
    if not (k.tpu_dsl_fastpath and k.tpu_use_pallas):
        return False
    if k.dimensionality != 3:
        return False
    return exe.device.type == "cuda" or _forced()


# ======================================================================
# AST matchers
# ======================================================================


@dataclass
class SmootherMatch:
    u: str
    f: str
    a: str
    omega: float
    n: int


@dataclass
class CalcResMatch:
    u: str
    f: str
    a: str
    res: str


def _const_f(exe, e) -> Optional[float]:
    try:
        return float(exe._eval_const(e))
    except Exception:
        return None


def _plain(e, name=None) -> Optional[str]:
    """A bare field/stencil access: no offset/slot/component/entry."""
    if not isinstance(e, N.Access):
        return None
    if e.offset or e.slot or e.component or e.sten_entry:
        return None
    if name is not None and e.name != name:
        return None
    return e.name


def _lvl(exe, spec, L) -> Optional[int]:
    if spec is None:
        return L
    try:
        lv = spec.resolve(exe.lo, exe.hi, L)
    except Exception:
        return None
    return lv[0] if len(lv) == 1 else None


def _is_parity2(e: N.Expr, ndim: int) -> bool:
    """(i0 + i1 + ... + i{ndim-1}) % 2 in any association order."""
    if not (isinstance(e, N.BinOp) and e.op == "%"
            and isinstance(e.rhs, N.Num) and int(e.rhs.value) == 2):
        return False
    leaves = []

    def flat(x):
        if isinstance(x, N.BinOp) and x.op == "+":
            flat(x.lhs)
            flat(x.rhs)
        elif isinstance(x, N.Access):
            leaves.append(x.name)
        else:
            leaves.append(None)

    flat(e.lhs)
    return sorted(filter(None, leaves)) == sorted(f"i{d}" for d in range(ndim)) \
        and None not in leaves


def _clean_loop(s: N.LoopOverField) -> bool:
    return (s.region is None and not s.on_boundary and s.reduction is None
            and s.condition is None and not s.sequentially
            and not s.starting and not s.ending and not s.stepping)


def match_smoother_stmts(exe, stmts: List[N.Stmt], L: int) -> Optional[SmootherMatch]:
    """Match a WHOLE statement list as one smoother block."""
    if len(stmts) != 1:
        return None
    s = stmts[0]
    n = 1
    if isinstance(s, N.RepeatTimes):
        # `repeat N times with contraction [..]` (IR_ContractingLoop,
        # baseExt/ir/IR_ContractingLoop.scala:43) is the reference's
        # temporal-blocking directive: fuse the N sweeps into one pass
        # with one (widened) exchange.  The fused smoother kernel IS
        # that transform — the clause selects the same kernel
        # the matcher picks, so it is accepted (not ignored) here.
        if s.count_var is not None:
            return None
        cnt = _const_f(exe, s.count)
        if cnt is None or int(cnt) != cnt or cnt < 1:
            return None
        n = int(cnt)
        if len(s.body) != 1:
            return None
        s = s.body[0]
    if not isinstance(s, N.ColorWith) or s.more_colors:
        return None
    if not _is_parity2(s.colors, exe.k.dimensionality):
        return None
    loop = None
    u = None
    for st in s.body:
        if isinstance(st, N.LoopOverField) and loop is None:
            loop = st
        elif isinstance(st, (N.Communicate, N.ApplyBC)):
            continue
        else:
            return None
    if loop is None or not _clean_loop(loop) or len(loop.body) != 1:
        return None
    u = _plain(loop.field)
    if u is None or _lvl(exe, loop.field.level, L) != L:
        return None
    a = loop.body[0]
    if not (isinstance(a, N.Assign) and a.op == "+="
            and _plain(a.target, u) and _lvl(exe, a.target.level, L) == L):
        return None
    v = a.value
    # (omega / diag(A)) * (f - A*u)
    if not (isinstance(v, N.BinOp) and v.op == "*"):
        return None
    w, corr = v.lhs, v.rhs
    if not (isinstance(w, N.BinOp) and w.op == "/"):
        return None
    omega = _const_f(exe, w.lhs)
    if omega is None:
        return None
    dg = w.rhs
    if not (isinstance(dg, N.Call) and dg.name == "diag" and len(dg.args) == 1):
        return None
    aname = _plain(dg.args[0])
    if aname is None or aname not in exe.stencils \
            or _lvl(exe, dg.args[0].level, L) != L:
        return None
    if not (isinstance(corr, N.BinOp) and corr.op == "-"):
        return None
    f = _plain(corr.lhs)
    conv = corr.rhs
    if f is None or _lvl(exe, corr.lhs.level, L) != L:
        return None
    if not (isinstance(conv, N.BinOp) and conv.op == "*"
            and _plain(conv.lhs, aname) and _plain(conv.rhs, u)
            and _lvl(exe, conv.lhs.level, L) == L
            and _lvl(exe, conv.rhs.level, L) == L):
        return None
    # the interleaved communicate/apply-bc statements must only touch u
    for st in s.body:
        if isinstance(st, (N.Communicate, N.ApplyBC)) \
                and (st.field.name != u or _lvl(exe, st.field.level, L) != L):
            return None
    return SmootherMatch(u=u, f=f, a=aname, omega=omega, n=n)


def _single_target(exe, s: N.Stmt, L: int):
    """ExprStmt calling exactly one zero-arg user function at level L."""
    if not (isinstance(s, N.ExprStmt) and isinstance(s.expr, N.Call)):
        return None
    e = s.expr
    if e.args:
        return None
    targets = exe._call_targets(e, L)
    if not targets or len(targets) != 1:
        return None
    fn, lvl = targets[0]
    if lvl != L or fn.params:
        return None
    return fn


def match_smoother_call(exe, s: N.Stmt, L: int) -> Optional[SmootherMatch]:
    fn = _single_target(exe, s, L)
    if fn is None:
        return None
    return match_smoother_stmts(exe, fn.body, L)


def match_calcres_call(exe, s: N.Stmt, L: int) -> Optional[CalcResMatch]:
    fn = _single_target(exe, s, L)
    if fn is None:
        return None
    body = [st for st in fn.body if not isinstance(st, N.Communicate)]
    loop = None
    if len(body) == 1 and isinstance(body[0], N.LoopOverField):
        loop = body[0]
    elif len(body) == 2 and isinstance(body[0], N.LoopOverField) \
            and isinstance(body[1], N.ApplyBC):
        loop = body[0]
        if body[1].field.name != _plain(loop.field) \
                or _lvl(exe, body[1].field.level, L) != L:
            return None
    else:
        return None
    if not _clean_loop(loop) or len(loop.body) != 1:
        return None
    res = _plain(loop.field)
    if res is None or _lvl(exe, loop.field.level, L) != L:
        return None
    a = loop.body[0]
    if not (isinstance(a, N.Assign) and a.op == "="
            and _plain(a.target, res) and _lvl(exe, a.target.level, L) == L):
        return None
    v = a.value
    if not (isinstance(v, N.BinOp) and v.op == "-"):
        return None
    f = _plain(v.lhs)
    conv = v.rhs
    if f is None or _lvl(exe, v.lhs.level, L) != L:
        return None
    if not (isinstance(conv, N.BinOp) and conv.op == "*"):
        return None
    aname = _plain(conv.lhs)
    u = _plain(conv.rhs)
    if aname is None or u is None or aname not in exe.stencils:
        return None
    if _lvl(exe, conv.lhs.level, L) != L or _lvl(exe, conv.rhs.level, L) != L:
        return None
    return CalcResMatch(u=u, f=f, a=aname, res=res)


def match_transfer_loop(exe, s: N.Stmt, L: int, kind: str):
    """kind='restrict': loop over X@(L-1) { X = R * src@L }  ->
         (X, R, src, '=')
       kind='prolong':  loop over X@L { X += P * src@(L-1) } ->
         (X, P, src, '+=')"""
    if not isinstance(s, N.LoopOverField) or not _clean_loop(s) \
            or len(s.body) != 1:
        return None
    out_lvl = L - 1 if kind == "restrict" else L
    src_lvl = L if kind == "restrict" else L - 1
    x = _plain(s.field)
    if x is None or _lvl(exe, s.field.level, L) != out_lvl:
        return None
    a = s.body[0]
    want_op = "=" if kind == "restrict" else "+="
    if not (isinstance(a, N.Assign) and a.op == want_op
            and _plain(a.target, x) and _lvl(exe, a.target.level, L) == out_lvl):
        return None
    v = a.value
    if not (isinstance(v, N.BinOp) and v.op == "*"):
        return None
    op = _plain(v.lhs)
    src = _plain(v.rhs)
    if op is None or src is None or op not in exe.stencils:
        return None
    if _lvl(exe, v.lhs.level, L) != L or _lvl(exe, v.rhs.level, L) != src_lvl:
        return None
    ig = exe.stencils[op].get(L)
    want = "restriction" if kind == "restrict" else "prolongation"
    if not (isinstance(ig, IntergridStencil) and ig.kind == want):
        return None
    return (x, op, src)


# ======================================================================
# plan construction
# ======================================================================


@dataclass
class Segment:
    start: int  # first statement index replaced
    end: int  # last statement index replaced (inclusive)
    run: Callable  # run(exe, fr) executing the fused equivalent


class FastPathPlanner:
    def __init__(self, exe):
        self.exe = exe
        self._plans = {}
        self._liveness: Optional[FieldLiveness] = None

    # ------------------------------------------------------------------
    def plan(self, stmts: List[N.Stmt], level: Optional[int]) -> List[Segment]:
        if level is None or not stmts:
            return []
        # keyed by statement identities, not list identity: the staged
        # partitioner hands out fresh sublist copies of stable AST nodes
        key = (tuple(id(s) for s in stmts), level)
        hit = self._plans.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], stmts)):
            return hit[1]
        # no catch: a planner or kernel-maker error raises rather than
        # leaving the statements to the plain ops unnoticed
        plan = self._build(stmts, level)
        self._plans[key] = (list(stmts), plan)
        return plan

    # ------------------------------------------------------------------
    def _field_ok(self, name: str, lvl: int, zero_dirichlet: bool) -> bool:
        exe = self.exe
        info = exe.fields.get(name)
        if info is None or lvl not in info.levels:
            return False
        if info.elem_shape or info.is_complex or info.num_slots != 1:
            return False
        if info.localization != NODE:
            return False
        if zero_dirichlet:
            bc = info.bc_by_level.get(lvl)
            if not (isinstance(bc, DirichletBC)
                    and isinstance(bc.value, (int, float))
                    and float(bc.value) == 0.0):
                return False
        return True

    def _star_stencil(self, name: str, lvl: int) -> Optional[BoundStencil]:
        if lvl not in self.exe.stencils.get(name, {}):
            return None
        st = self.exe._stencil_at(name, lvl)
        if not isinstance(st, BoundStencil):
            return None
        shape = tuple(self.exe.grids[lvl].shape_of(NODE))
        # below 33^3 a level is latency-bound either way and runs the
        # plain ops (the reference's threshold, so one Knowledge gives the
        # same segments in both packages).  Forced (test) mode fuses
        # everything so tiny grids exercise the path.
        min_n = 5 if _forced() else 33
        if min(shape) < min_n:
            return None
        if not cuda_applicable_3d(shape, st.offsets, st.coefs):
            return None
        return st

    # ------------------------------------------------------------------
    def _build(self, stmts: List[N.Stmt], L: int) -> List[Segment]:
        exe = self.exe
        segs: List[Segment] = []
        i = 0
        n = len(stmts)
        while i < n:
            leg = self._try_down_leg(stmts, i, L)
            if leg is not None:
                segs.append(leg)
                i = leg.end + 1
                continue
            leg = self._try_up_leg(stmts, i, L)
            if leg is not None:
                segs.append(leg)
                i = leg.end + 1
                continue
            sm = match_smoother_call(exe, stmts[i], L) \
                or match_smoother_stmts(exe, stmts[i:i + 1], L)
            if sm is not None:
                seg = self._make_smoother_seg(sm, i, L)
                if seg is not None:
                    segs.append(seg)
                    i = seg.end + 1
                    continue
            i += 1
        return segs

    # ------------------------------------------------------------------
    def _smoother_env_ok(self, sm: SmootherMatch, L: int) -> bool:
        return (self._field_ok(sm.u, L, zero_dirichlet=True)
                and self._field_ok(sm.f, L, zero_dirichlet=False)
                and self._star_stencil(sm.a, L) is not None)

    def _make_smoother_seg(self, sm: SmootherMatch, i: int, L: int) -> Optional[Segment]:
        exe = self.exe
        if not self._smoother_env_ok(sm, L):
            return None
        A = self._star_stencil(sm.a, L)
        shape = exe.true_shape(sm.u, L)
        fieldU = Field(sm.u, exe.domain, NODE,
                       bc=exe.fields[sm.u].bc_by_level.get(L))
        smooth_n = make_fused_smoother_3d(A, fieldU, L, shape, sm.omega, 2)
        if smooth_n is None:
            return None
        u, f, nit = sm.u, sm.f, sm.n

        def run(exe, fr, _u=u, _f=f, _n=nit, _fn=smooth_n, _L=L):
            sol = exe.own_field(_u, _L)  # K3 updates it in place
            rhs = exe.get_field(_f, _L)
            exe.set_field(_u, _L, _fn(_n, sol, rhs))

        return Segment(i, i, run)

    # ------------------------------------------------------------------
    def _owning_function(self, stmts: List[N.Stmt], L: int):
        """(name, level, body, offset) of the function whose top-level
        body contains this exact statement run (the staged partitioner
        hands out sublist copies, so match by statement identity)."""
        if not stmts:
            return None
        for (fname, flvl), decl in self.exe.functions.items():
            if flvl != L:
                continue
            body = decl.body
            for off in range(len(body) - len(stmts) + 1):
                if body[off] is stmts[0] and all(
                    body[off + i] is stmts[i] for i in range(len(stmts))
                ):
                    return fname, flvl, body, off
        return None

    def _try_down_leg(self, stmts, i, L) -> Optional[Segment]:
        exe = self.exe
        if L <= exe.lo or i + 2 >= len(stmts):
            return None
        sm = match_smoother_call(exe, stmts[i], L)
        if sm is None:
            return None
        cr = match_calcres_call(exe, stmts[i + 1], L)
        if cr is None or (cr.u, cr.f, cr.a) != (sm.u, sm.f, sm.a):
            return None
        j = i + 2
        if j < len(stmts) and isinstance(stmts[j], N.Communicate) \
                and stmts[j].field.name == cr.res:
            j += 1
        if j >= len(stmts):
            return None
        tr = match_transfer_loop(exe, stmts[j], L, "restrict")
        if tr is None:
            return None
        rhs_c, rop, src = tr
        if src != cr.res:
            return None
        # environment checks
        if not (self._smoother_env_ok(sm, L)
                and self._field_ok(cr.res, L, zero_dirichlet=True)
                and self._field_ok(rhs_c, L - 1, zero_dirichlet=False)):
            return None
        # the residual store is elided -> its interior must be dead on
        # every continuation of the transformed program
        span_ids = frozenset(id(s) for s in stmts[i:j + 1])
        owner = self._owning_function(stmts, L)
        if owner is None:
            return None
        fname, flvl, body, off = owner
        if self._liveness is None:
            self._liveness = FieldLiveness(exe)
        if not self._liveness.interior_dead_after(
            fname, flvl, body, off + j, (cr.res, L), span_ids, L
        ):
            return None
        # also need the matching up-leg's prolongation op to build the
        # paired kernels; find it anywhere after j
        up = None
        for m in range(j + 1, len(stmts)):
            t = match_transfer_loop(exe, stmts[m], L, "prolong")
            if t is not None and t[0] == sm.u:
                up = t
                break
        if up is None:
            return None
        built = self._build_legs(sm, cr, rop, up[1], L, n_post=sm.n)
        if built is None:
            return None
        down_fn, _ = built
        u, f = sm.u, sm.f
        res = cr.res
        coarse_info = exe.fields[rhs_c]
        cshape = tuple(exe.true_shape(rhs_c, L - 1))
        bmask = None
        dup = coarse_info.dup_layers
        if dup is None:
            dup = (1,) * len(cshape)
        if any(d > 0 for d in dup[:len(cshape)]):
            bmask = np.ones(cshape, bool)
            for d, dl in enumerate(dup[:len(cshape)]):
                if dl > 0:
                    sl = [slice(None)] * len(cshape)
                    sl[d] = 0
                    bmask[tuple(sl)] = False
                    sl[d] = cshape[d] - 1
                    bmask[tuple(sl)] = False
            bmask = torch.as_tensor(bmask, device=exe.device)
        calcres_fn = _single_target(exe, stmts[i + 1], L)

        def run(exe, fr, _u=u, _f=f, _res=res, _rhs_c=rhs_c, _L=L,
                _down=down_fn, _mask=bmask, _cr=calcres_fn):
            sol = exe.own_field(_u, _L)  # K1 updates it in place
            rhs = exe.get_field(_f, _L)
            sol, rc = _down(sol, rhs)
            exe.set_field(_u, _L, sol)
            if _mask is not None:
                # the source loop writes the interior only; keep the
                # coarse rhs boundary ring exactly as the plain path
                rc = torch.where(_mask, rc, exe.get_field(_rhs_c, _L - 1))
            exe.set_field(_rhs_c, _L - 1, rc)
            # dead-store elision: materialize on (external) read by
            # replaying the source CalcRes for the current iterate
            exe.mark_stale(
                (_res, _L),
                lambda exe=exe, fn=_cr, lvl=_L: exe.call_function(fn, lvl, []),
            )

        return Segment(i, j, run)

    def _try_up_leg(self, stmts, i, L) -> Optional[Segment]:
        exe = self.exe
        if L <= exe.lo:
            return None
        j = i
        if j < len(stmts) and isinstance(stmts[j], N.Communicate):
            # `communicate ghost of u@coarser`
            if _lvl(exe, stmts[j].field.level, L) != L - 1:
                return None
            j += 1
        if j >= len(stmts):
            return None
        tr = match_transfer_loop(exe, stmts[j], L, "prolong")
        if tr is None:
            return None
        u, pop, src = tr
        j += 1
        if j < len(stmts) and isinstance(stmts[j], N.ApplyBC) \
                and stmts[j].field.name == u:
            j += 1
        if j >= len(stmts):
            return None
        sm = match_smoother_call(exe, stmts[j], L)
        if sm is None or sm.u != u:
            return None
        if not (self._smoother_env_ok(sm, L)
                and self._field_ok(src, L - 1, zero_dirichlet=True)):
            return None
        # find the paired restriction op (same program, any down leg)
        rop = None
        for name, per_level in exe.stencils.items():
            ig = per_level.get(L)
            if isinstance(ig, IntergridStencil) and ig.kind == "restriction":
                rop = name
                break
        if rop is None:
            return None
        built = self._build_legs(sm, None, rop, pop, L, n_post=sm.n)
        if built is None:
            return None
        _, up_fn = built

        def run(exe, fr, _u=u, _f=sm.f, _src=src, _L=L, _up=up_fn):
            sol = exe.own_field(_u, _L)  # K2 updates it in place
            sol_c = exe.get_field(_src, _L - 1)
            rhs = exe.get_field(_f, _L)
            exe.set_field(_u, _L, _up(sol, sol_c, rhs))

        return Segment(i, j, run)

    # ------------------------------------------------------------------
    def _build_legs(self, sm: SmootherMatch, cr, rop: str, pop: str,
                    L: int, n_post: int):
        exe = self.exe
        key = ("legs", sm.u, sm.f, sm.a, rop, pop, L, sm.n, n_post, sm.omega)
        if key in self._plans:
            return self._plans[key]
        A = self._star_stencil(sm.a, L)
        if A is None:
            return None
        r_ig = exe.stencils[rop].get(L)
        p_ig = exe.stencils[pop].get(L)
        if not isinstance(r_ig, IntergridStencil) \
                or not isinstance(p_ig, IntergridStencil):
            return None
        fine = tuple(exe.true_shape(sm.u, L))
        coarse = tuple(exe.grids[L - 1].shape_of(NODE))
        fieldU = Field(sm.u, exe.domain, NODE,
                       bc=exe.fields[sm.u].bc_by_level.get(L))
        down, up = make_fused_legs_3d(
            A, fieldU, L, fine, coarse, r_ig, p_ig, sm.omega, sm.n, n_post, 2)
        if down is None or up is None:
            return None
        self._plans[key] = (down, up)
        return down, up
