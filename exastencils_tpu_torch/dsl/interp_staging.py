"""Staged execution of L4 statement runs: the counterpart of the
reference's jitted runs as CUDA-graph recordings.

Reference: exastencils_tpu/dsl/interp_staging.py.  The static analysis
is the reference's, rule for rule: which calls block staging
(`_STAGE_BLOCKED_CALLS`, `_STAGE_SAFE_CALLS`), the partition of a block
into runs (`_partition_stmts`), which statements and functions stage
(`_stmt_stageable`, `_expr_stageable`, `_fn_stageable`), the names a run
references (`_stmt_refs`), and the early-exit repeat (`_match_early_exit_repeat`,
`_body_mutates_slots`, `_ee_signature`).  Execution differs:

- a staged run (`_run_staged`) is captured with runtime/staging: two
  warm-ups on copies of its state (the second with host reads forbidden),
  then one `Recording` of its statements on static buffers, replayed by
  every later execution with the same cache key.  The key is the
  reference's: the statements and level, the traced scalars (floats and
  non-bool ints, in 0-d static buffers, so a counter does not re-capture)
  with their types, the constant ones by value, the slot snapshot, the
  state keys and the unproven stale set.  The static state buffers are
  the stored tensors themselves (cloned where another name holds their
  storage): a replay updates the fields in place and the run's results
  are written back into them inside the capture; the scalars it returns
  are cloned out of the graph pool.
- the early-exit repeat is a device loop (runtime/staging.device_loop):
  outside a run, one recording of its own with one host read for the
  early return; in tail position inside a run, it ends the run's current
  graph segment, records the loop and starts the next segment.
- a run whose warm-up reads a device value on the host, or writes a
  state key the scan missed, stays eager (the reference blacklists a run
  whose trace fails); such runs are counted in `staging_stats()` and
  reported once.  Any other error raises.
"""

from __future__ import annotations

import time
import warnings
from typing import List

import numpy as np
import torch

from exastencils_tpu_torch.core.matval import MatVal, is_mat
from exastencils_tpu_torch.dsl import nodes as N
from exastencils_tpu_torch.dsl.interp_base import _MATH_FNS, Frame, is_py_float, py_float
from exastencils_tpu_torch.runtime.staging import (
    Recording,
    UnscannedWrite,
    device_loop,
    is_host_read,
    read_flag,
    warm_up,
)

# why the runs of a sharded DSL program stay eager (dsl/interp_fragments)
EAGER_REASON = ("sharded run: halo exchanges and all-reduces are host-driven messages, "
                "which a CUDA graph does not capture")


def _never_exits(cond: N.Expr) -> bool:
    """The never-true exit that exec_stmt gives a large no-exit repeat."""
    return isinstance(cond, N.Num) and float(cond.value) == 0


def _clone_value(v):
    """A run's scalar result out of the graph pool (a traced Python float
    stays one)."""
    if is_mat(v):
        return MatVal(v.data.clone())
    if not isinstance(v, torch.Tensor):
        return v
    return py_float(v.clone()) if is_py_float(v) else v.clone()


class L4StagingMixin:
    # ------------------------------------------------------------------
    # staged execution: capture maximal stageable statement runs
    #
    # The reference compiles every L4 function to C++; here the analog
    # is capturing runs of statements into ONE recording of CUDA graphs.
    # Runs are split at statements that need Python control flow (repeat
    # until, conditional return/break) or host effects (print, timers,
    # IO): those execute eagerly, and e.g. a generated `Solve` degrades
    # to "eager while-loop around one replayed V-cycle per level".
    _STAGE_BLOCKED_CALLS = frozenset({
        "print", "printWithReducedPrec", "printAllTimers",
        "printAllTimersToFile", "startTimer", "stopTimer",
        "benchmarkStart", "benchmarkStop", "printJSON",
        "getTotalTime", "getTotalFromTimer", "getMeanTime",
        "getMeanFromTimer", "native", "writeField", "readField",
        "printField", "printVtk", "printVtkNS", "printVtkNNF", "printVtkSWE",
        "compare", "classifyMatShape",
        "evalMOpRuntimeExe", "initFieldsWithZero", "initGlobals",
        "readParameterFile",
    })
    _STAGE_SAFE_CALLS = frozenset({
        "min", "max", "pow", "diag", "diag_inv", "transpose",
        "transposed", "dot", "dotProduct", "cross", "trace", "det",
        "determinant", "inverse", "inv", "norm", "frobeniusNorm",
        "getElement", "setElement", "getSlice", "setSlice", "toMatrix",
        "Re", "re", "real", "Im", "im", "imag", "conj", "arg", "polar",
        "notEqual", "getKnowledge", "levels", "initDomain",
        "initGeometry", "destroyGlobals", "initFragments",
    })

    def _partition_stmts(self, stmts: List[N.Stmt], fr: Frame, loop):
        """Split a statement list into (run, staged?) groups.  A sharded
        run (dsl/interp_fragments) stages nothing: each run that would be
        staged is counted once as left eager, with the reason."""
        if self.frag is not None and self.jit_functions:
            for run, staged in self._stage_runs(stmts, fr, loop):
                key = (id(run[0]), len(run), fr.level)
                if staged and key not in self._eager_runs:
                    self._eager_runs.add(key)
                    self.stage_stats.unstaged += 1
                    self._unstaged[f"run@{fr.level} #{len(self._unstaged)}"] = EAGER_REASON
                yield run, False
            return
        yield from self._stage_runs(stmts, fr, loop)

    def _stage_runs(self, stmts: List[N.Stmt], fr: Frame, loop):
        if not self.jit_functions or loop is not None or self._in_trace:
            yield stmts, False
            return
        run: List[N.Stmt] = []

        def flush():
            if run:
                yield list(run), any(self._has_field_work(s, fr.level) for s in run)
                run.clear()

        for s in stmts:
            if self._stmt_stageable(s, fr.level):
                run.append(s)
            else:
                yield from flush()
                yield [s], False
        yield from flush()

    def _has_field_work(self, s, level) -> bool:
        """Worth jitting? (contains grid work, not just scalar decls)"""
        if isinstance(s, (N.LoopOverField, N.ColorWith, N.RepeatWith,
                          N.ApplyBC, N.SolveLocally, N.SolveMatSys,
                          N.Communicate)):
            return True
        if isinstance(s, (N.RepeatTimes, N.LoopOverFragments, N.LevelScope)):
            return any(self._has_field_work(x, level) for x in s.body)
        if isinstance(s, N.If):
            return any(self._has_field_work(x, level)
                       for x in s.then_body + s.else_body)
        if isinstance(s, N.VarDecl):
            return s.init is not None and self._calls_user_fn(s.init)
        if isinstance(s, N.Assign):
            return self._calls_user_fn(s.value)
        if isinstance(s, N.ExprStmt):
            return self._calls_user_fn(s.expr)
        return False

    def _calls_user_fn(self, e) -> bool:
        if isinstance(e, N.Call):
            if any(k[0] == e.name for k in self.functions):
                return True
            return any(self._calls_user_fn(a) for a in e.args)
        if isinstance(e, N.BinOp):
            return self._calls_user_fn(e.lhs) or self._calls_user_fn(e.rhs)
        if isinstance(e, N.UnOp):
            return self._calls_user_fn(e.operand)
        return False

    def _call_targets(self, e: N.Call, level):
        """FunctionDecls an L4 call can bind to (with their levels)."""
        out = []
        if e.level is not None:
            try:
                lvls = e.level.resolve(self.lo, self.hi, level)
            except Exception:
                return None  # unresolvable at scan time
            for l in lvls:
                if (e.name, l) in self.functions:
                    out.append((self.functions[(e.name, l)], l))
        else:
            if (e.name, level) in self.functions:
                out.append((self.functions[(e.name, level)], level))
            elif (e.name, None) in self.functions:
                out.append((self.functions[(e.name, None)], level))
        return out

    def _stmt_stageable(self, s, level) -> bool:
        key = (id(s), level)
        memo = self._stageable_memo
        if key in memo:
            return memo[key]
        memo[key] = True  # break recursion cycles optimistically
        ok = self._stageable_impl(s, level)
        memo[key] = ok
        return ok

    def _stageable_impl(self, s, level) -> bool:
        if isinstance(s, (N.Return, N.Break, N.RepeatUntil)):
            return False
        if isinstance(s, N.VarDecl):
            return s.init is None or self._expr_stageable(s.init, level)
        if isinstance(s, N.Assign):
            return self._expr_stageable(s.value, level)
        if isinstance(s, N.If):
            return (self._expr_stageable(s.cond, level)
                    and all(self._stmt_stageable(x, level) for x in s.then_body)
                    and all(self._stmt_stageable(x, level) for x in s.else_body))
        if isinstance(s, N.RepeatTimes):
            # large static repeats UNROLL into the enclosing run (a
            # `repeat 128 times` Smoother coarse solve captured 128
            # times over — LinearElasticity).  Refuse staging here; the
            # eager encounter then lowers the loop to ONE device loop
            # (exec_stmt's large-repeat path) whose body is captured
            # once.  Early-exit repeats are unaffected (they already
            # lower to a device loop).
            if (isinstance(s.count, N.Num) and float(s.count.value) > 24
                    and any(isinstance(x, (N.LoopOverField, N.ColorWith))
                            for x in s.body)):
                return False
            return (self._expr_stageable(s.count, level)
                    and all(self._stmt_stageable(x, level) for x in s.body))
        if isinstance(s, (N.LoopOverFragments, N.ColorWith, N.RepeatWith,
                          N.LevelScope)):
            return all(self._stmt_stageable(x, level) for x in s.body)
        if isinstance(s, N.LoopOverField):
            return (
                (s.condition is None or self._expr_stageable(s.condition, level))
                and all(self._stmt_stageable(x, level) for x in s.body)
            )
        if isinstance(s, (N.Communicate, N.ApplyBC)):
            # automatic category timing needs these to run eagerly so
            # each occurrence is individually measurable (the reference
            # instruments the generated functions the same way,
            # IR_AutomaticFunctionTiming); perturbation-by-observation
            # is inherent to the feature
            cat = "COMM" if isinstance(s, N.Communicate) else "APPLYBC"
            return not self.timers.auto_enabled(cat)
        if isinstance(s, (N.Advance, N.SolveMatSys)):
            return True
        if isinstance(s, N.SolveLocally):
            return all(
                self._expr_stageable(lhs, level) and self._expr_stageable(rhs, level)
                for lhs, rhs in s.equations
            )
        if isinstance(s, N.ExprStmt):
            return self._expr_stageable(s.expr, level)
        return False

    def _expr_stageable(self, e, level) -> bool:
        if isinstance(e, (N.Num, N.Str)) or e is None:
            return True
        if isinstance(e, N.Access):
            return True
        if isinstance(e, N.UnOp):
            return self._expr_stageable(e.operand, level)
        if isinstance(e, N.BinOp):
            return self._expr_stageable(e.lhs, level) and self._expr_stageable(e.rhs, level)
        if isinstance(e, N.MatrixLit):
            return all(self._expr_stageable(x, level) for row in e.rows for x in row)
        if isinstance(e, N.TensorLit):
            return all(self._expr_stageable(x, level) for _, x in e.entries)
        if isinstance(e, N.Call):
            if e.name in self._STAGE_BLOCKED_CALLS or e.name == "exit" \
                    or e.name.startswith(
                        ("writeField_", "readField_", "printField_")):
                return False
            if not all(self._expr_stageable(a, level) for a in e.args):
                return False
            if e.name in _MATH_FNS or e.name in self._STAGE_SAFE_CALLS \
                    or (e.name.startswith(("integrateOver", "evalAt"))
                        and e.name.endswith("Face")):
                return True
            targets = self._call_targets(e, level)
            if targets is None or not targets:
                return False
            return all(self._fn_stageable(fn, lvl) for fn, lvl in targets)
        return False

    def _fn_stageable(self, fn: N.FunctionDecl, level) -> bool:
        """A called function stages if its body does — a single trailing
        unconditional Return is fine (it raises _Return deterministically
        at trace time)."""
        key = (id(fn), level)
        memo = self._stageable_memo
        if key in memo:
            return memo[key]
        memo[key] = True  # optimistic for recursion (mgCycle@l -> @l-1)
        body = fn.body
        tail_ok = True
        if body and isinstance(body[-1], N.Return):
            tail_ok = body[-1].value is None or self._expr_stageable(body[-1].value, level)
            body = body[:-1]
        elif body and isinstance(body[-1], N.RepeatTimes) and \
                self._match_early_exit_repeat(body[-1], level) is not None:
            # a tail-position early-exit repeat lowers to a device loop
            # inline (its `return` == break) — whole function stageable
            body = body[:-1]
        ok = tail_ok and all(self._stmt_stageable(x, level) for x in body)
        memo[key] = ok
        return ok

    # ---- referenced / free names of a run (for trace signatures) ----
    def _stmt_refs(self, s, level) -> frozenset:
        key = (id(s), level)
        if key in self._refs_memo:
            return self._refs_memo[key]
        self._refs_memo[key] = frozenset()  # cycle guard
        out = set()

        def expr(e):
            if e is None:
                return
            if isinstance(e, N.Access):
                out.add(e.name)
                if e.component:
                    for c in e.component:
                        for x in c[1:]:
                            if isinstance(x, N.Expr):
                                expr(x)
            elif isinstance(e, N.BinOp):
                expr(e.lhs); expr(e.rhs)
            elif isinstance(e, N.UnOp):
                expr(e.operand)
            elif isinstance(e, N.MatrixLit):
                for row in e.rows:
                    for x in row:
                        expr(x)
            elif isinstance(e, N.TensorLit):
                for _, x in e.entries:
                    expr(x)
            elif isinstance(e, N.Call):
                for a in e.args:
                    expr(a)
                for fn, lvl in (self._call_targets(e, level) or []):
                    for st in fn.body:
                        out.update(self._stmt_refs(st, lvl))

        if isinstance(s, N.VarDecl):
            expr(s.init)
        elif isinstance(s, N.Assign):
            out.add(s.target.name)
            expr(s.value)
        elif isinstance(s, N.If):
            expr(s.cond)
            for x in s.then_body + s.else_body:
                out.update(self._stmt_refs(x, level))
        elif isinstance(s, N.RepeatTimes):
            expr(s.count)
            for x in s.body:
                out.update(self._stmt_refs(x, level))
        elif isinstance(s, (N.LoopOverFragments, N.LevelScope, N.RepeatWith,
                            N.ColorWith)):
            if isinstance(s, N.ColorWith):
                expr(s.colors)
                for c in s.more_colors:
                    expr(c)
            if isinstance(s, N.RepeatWith):
                for c in s.conditions:
                    expr(c)
            for x in s.body:
                out.update(self._stmt_refs(x, level))
        elif isinstance(s, N.LoopOverField):
            out.add(s.field.name)
            expr(s.condition)
            if s.reduction:
                out.add(s.reduction[1])
            for x in s.body:
                out.update(self._stmt_refs(x, level))
        elif isinstance(s, (N.Communicate, N.ApplyBC, N.Advance)):
            out.add(s.field.name)
        elif isinstance(s, N.SolveLocally):
            expr(s.relax)
            for u in s.unknowns:
                out.add(u.name)
            for lhs, rhs in s.equations:
                expr(lhs); expr(rhs)
        elif isinstance(s, N.SolveMatSys):
            out.update({s.A.name, s.u.name, s.f.name})
        elif isinstance(s, N.ExprStmt):
            expr(s.expr)
        elif isinstance(s, N.Return):
            expr(s.value)
        res = frozenset(out)
        self._refs_memo[key] = res
        return res


    def _match_early_exit_repeat(self, s: N.RepeatTimes, level):
        """(pre, cond, post) when the body is `pre; if cond {return}; post`
        with everything else traceable, else None."""
        exit_idx = None
        for i, st in enumerate(s.body):
            if (isinstance(st, N.If) and not st.else_body
                    and len(st.then_body) == 1
                    and isinstance(st.then_body[0], N.Return)
                    and st.then_body[0].value is None):
                if exit_idx is not None:
                    return None
                exit_idx = i
        if exit_idx is None:
            return None
        pre = list(s.body[:exit_idx])
        post = list(s.body[exit_idx + 1:])
        cond = s.body[exit_idx].cond
        if not all(self._stmt_stageable(x, level) for x in pre + post):
            return None
        if not (self._expr_stageable(cond, level)
                and self._expr_stageable(s.count, level)):
            return None
        if self._body_mutates_slots(s.body, level):
            return None  # Advance would mutate Python slot state per iter
        return pre, cond, post

    def _body_mutates_slots(self, stmts, level, _seen=None) -> bool:
        _seen = _seen if _seen is not None else set()
        for st in stmts:
            if isinstance(st, N.Advance):
                return True
            for attr in ("body", "then_body", "else_body"):
                sub = getattr(st, attr, None)
                if sub and self._body_mutates_slots(sub, level, _seen):
                    return True
            exprs = []
            if isinstance(st, N.VarDecl) and st.init is not None:
                exprs.append(st.init)
            elif isinstance(st, N.Assign):
                exprs.append(st.value)
            elif isinstance(st, N.ExprStmt):
                exprs.append(st.expr)
            for e in exprs:
                for fn2, lvl in self._calls_in_expr(e, level):
                    key = (id(fn2), lvl)
                    if key in _seen:
                        continue
                    _seen.add(key)
                    if self._body_mutates_slots(fn2.body, lvl, _seen):
                        return True
        return False

    def _calls_in_expr(self, e, level):
        out = []

        def walk(x):
            if isinstance(x, N.Call):
                for a in x.args:
                    walk(a)
                out.extend(self._call_targets(x, level) or [])
            elif isinstance(x, N.BinOp):
                walk(x.lhs)
                walk(x.rhs)
            elif isinstance(x, N.UnOp):
                walk(x.operand)

        walk(e)
        return out

    def _ee_signature(self, s: N.RepeatTimes, fr: Frame):
        """(traced_names, const_items, state_keys, lookup) of the loop."""
        refs = set()
        for st in s.body:
            refs |= self._stmt_refs(st, fr.level)
        for nm in [nm for nm in refs if nm in self.stencils]:
            for entry2 in self.stencils[nm].values():
                if isinstance(entry2, tuple) and entry2 and entry2[0] == "__decl__":
                    for en in entry2[1].entries:
                        refs |= self._referenced_names(en.coef)
                elif isinstance(entry2, tuple) and entry2 and entry2[0] == "__sexpr__":
                    refs |= self._referenced_names(entry2[1].expr)

        def lookup(nm):
            return fr.vars[nm] if nm in fr.vars else self.globals.get(nm)

        var_names = sorted(
            nm for nm in refs
            if nm not in self.fields and nm not in self.stencils
            and nm != s.count_var
            and (nm in fr.vars or nm in self.globals)
        )
        if any(is_mat(lookup(nm)) for nm in var_names):
            return None  # matrix-valued carry not supported

        def traceable(v):
            return isinstance(v, (int, float, complex, np.floating, np.integer)) \
                or hasattr(v, "shape")

        traced_names = tuple(
            nm for nm in var_names
            if lookup(nm) is not None and traceable(lookup(nm))
        )
        const_items = tuple(
            (nm, repr(lookup(nm))) for nm in var_names if nm not in traced_names
        )
        # carry only the (field, level) instances the loop touches: the
        # while carry is copied through per-iteration selects, so pulling
        # every level of a field name in would copy the FINE grids once
        # per coarse-CG iteration
        touched = set()
        exact = True
        for st in s.body:
            t = self._stmt_field_levels(st, fr.level)
            if t is None:
                exact = False
                break
            touched |= t
        # stencil-coefficient field reads: include all levels (rare)
        coef_names = {nm for nm in refs if nm in self.stencils}
        if exact:
            state_keys = tuple(sorted(
                k2 for k2 in self.state
                if k2 in touched or (k2[0] in refs and k2[0] in coef_names)
                or ("__ghost" in k2[0]
                    and (k2[0].split("__ghost")[0], k2[1]) in touched)
            ))
        else:
            state_keys = tuple(sorted(
                k2 for k2 in self.state
                if k2[0] in refs or k2[0].split("__ghost")[0] in refs
            ))
        return traced_names, const_items, state_keys, lookup

    def _stmt_field_levels(self, s, level, _seen=None):
        """Set of (field, level) instances a statement can touch, or
        None when a level spec cannot be resolved statically."""
        _seen = _seen if _seen is not None else set()
        out = set()
        fr = Frame({}, level)

        def res(spec):
            try:
                return self._resolve_level(spec, fr)
            except Exception:
                return None

        bad = []

        def expr(e, lvl):
            if e is None:
                return
            if isinstance(e, N.Access):
                if e.name in self.fields:
                    r = res(e.level) if e.level is not None else lvl
                    if r is None:
                        bad.append(e.name)
                    else:
                        out.add((e.name, r))
            elif isinstance(e, N.BinOp):
                expr(e.lhs, lvl)
                expr(e.rhs, lvl)
            elif isinstance(e, N.UnOp):
                expr(e.operand, lvl)
            elif isinstance(e, N.MatrixLit):
                for row in e.rows:
                    for x in row:
                        expr(x, lvl)
            elif isinstance(e, N.Call):
                for a in e.args:
                    expr(a, lvl)
                for fn2, l2 in (self._call_targets(e, lvl) or []):
                    key = (id(fn2), l2)
                    if key in _seen:
                        continue
                    _seen.add(key)
                    for st2 in fn2.body:
                        sub = self._stmt_field_levels(st2, l2, _seen)
                        if sub is None:
                            bad.append(e.name)
                        else:
                            out.update(sub)

        if isinstance(s, (N.Communicate, N.ApplyBC, N.Advance)):
            r = res(s.field.level) if s.field.level is not None else level
            if r is None:
                return None
            out.add((s.field.name, r))
        elif isinstance(s, N.VarDecl):
            expr(s.init, level)
        elif isinstance(s, N.Assign):
            if s.target.name in self.fields:
                r = res(s.target.level) if s.target.level is not None else level
                if r is None:
                    return None
                out.add((s.target.name, r))
            expr(s.value, level)
        elif isinstance(s, N.If):
            expr(s.cond, level)
            for x in s.then_body + s.else_body:
                sub = self._stmt_field_levels(x, level, _seen)
                if sub is None:
                    return None
                out.update(sub)
        elif isinstance(s, (N.RepeatTimes, N.LoopOverFragments, N.LevelScope,
                            N.RepeatWith, N.ColorWith)):
            if isinstance(s, N.RepeatTimes):
                expr(s.count, level)
            for x in s.body:
                sub = self._stmt_field_levels(x, level, _seen)
                if sub is None:
                    return None
                out.update(sub)
        elif isinstance(s, N.LoopOverField):
            r = res(s.field.level) if s.field.level is not None else level
            if r is None:
                return None
            out.add((s.field.name, r))
            expr(s.condition, level)
            for x in s.body:
                sub = self._stmt_field_levels(x, level, _seen)
                if sub is None:
                    return None
                out.update(sub)
        elif isinstance(s, N.SolveLocally):
            for u in s.unknowns:
                r = res(u.level) if u.level is not None else level
                if r is None:
                    return None
                out.add((u.name, r))
            for lhs, rhs in s.equations:
                expr(lhs, level)
                expr(rhs, level)
        elif isinstance(s, N.ExprStmt):
            expr(s.expr, level)
        elif isinstance(s, N.Return):
            expr(s.value, level)
        return None if bad else out


    # ------------------------------------------------------------------
    # staged runs: one recording per (statements, level, signature)
    # ------------------------------------------------------------------

    def staging_stats(self) -> dict:
        """Counters of the staged executor (runtime/staging.StageStats),
        the runs left eager, with the reason for each, and the field IO
        builtins run (eager, each a copy to or from the host)."""
        out = self.stage_stats.as_dict()
        out["unstaged_runs"] = dict(self._unstaged)
        out["io_calls"] = self._io_calls
        return out

    def _recording_name(self, what: str, fr: Frame) -> str:
        """`<function>[@level].<what><n>`: the recording's name in its spans,
        n counting the recordings of the executable."""
        fn = self._calls[-1][0].name if self._calls else "main"
        at = "" if fr.level is None else f"@{fr.level}"
        return f"{fn}{at}.{what}{self.stage_stats.captures}"

    def _leave_eager(self, key0, what: str, err: BaseException):
        """A run (or early-exit loop) whose warm-up read a device value on
        the host or wrote an unscanned state key stays eager from now on,
        as the reference blacklists a run whose trace fails; it is counted
        and reported once."""
        self._stage_blacklist.add(key0)
        self.stage_stats.unstaged += 1
        why = f"{type(err).__name__}: {err}"
        self._unstaged[f"{what} #{len(self._unstaged)}"] = why
        warnings.warn(f"{what} left eager ({why})", RuntimeWarning, stacklevel=3)

    def _device_value(self, v):
        """A traced value as a tensor on the executable's device: Python
        numbers as 0-d tensors (float64, int64, complex128, bool: the
        precision Python computes in; a float marked as a traced Python
        float, interp_base.py_float), tensors as they are."""
        if is_mat(v):
            return v
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, (bool, np.bool_)):
            return torch.full((), bool(v), dtype=torch.bool, device=self.device)
        if isinstance(v, (int, np.integer)):
            return torch.full((), int(v), dtype=torch.int64, device=self.device)
        if isinstance(v, complex):
            return torch.full((), v, dtype=torch.complex128, device=self.device)
        return py_float(torch.full((), float(v), dtype=torch.float64, device=self.device))

    def _static_value(self, v):
        """A fresh static buffer holding traced value `v`."""
        return _clone_value(self._device_value(v))

    @staticmethod
    def _value_sig(v):
        """What a traced value's static buffer must match: a Python number
        keys as the 0-d tensor `_device_value` makes of it, so a counter
        that a replay hands back as a tensor does not re-capture."""
        mat = is_mat(v)
        if mat:
            v = v.data
        if isinstance(v, torch.Tensor):
            return (v.dtype, tuple(v.shape), mat, is_py_float(v))
        if isinstance(v, (bool, np.bool_)):
            return (torch.bool, (), False, False)
        if isinstance(v, (int, np.integer)):
            return (torch.int64, (), False, False)
        if isinstance(v, complex):
            return (torch.complex128, (), False, False)
        return (torch.float64, (), False, True)

    @staticmethod
    def _load_value(buf, v):
        """Copy traced value `v` into its static buffer."""
        if is_mat(buf):
            buf, v = buf.data, v.data
        if isinstance(v, torch.Tensor):
            buf.copy_(v)
        else:
            buf.fill_(v)

    def _adopt(self, keys):
        """Static state buffers for `keys`: the stored tensors themselves,
        unless another name holds their storage."""
        out = []
        for k2 in keys:
            t = self.state[k2]
            if self._shares_storage(t, skip=k2):
                t = t.clone()
            out.append(t)
        return out

    def _bind_state(self, keys, static):
        """Before a replay: the state of `keys` lives in the static buffers
        (a copy where a statement replaced the stored tensor), and no frame
        variable or global keeps a buffer's storage, which the replay
        updates in place."""
        for k2, buf in zip(keys, static):
            cur = self.state[k2]
            if cur is not buf:
                buf.copy_(cur)
                self.state[k2] = buf
        ptrs = {buf.untyped_storage().data_ptr() for buf in static}
        for env in [f.vars for f in self._frames] + [self.globals]:
            for n, v in list(env.items()):
                t = v.data if is_mat(v) else v
                if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() in ptrs:
                    env[n] = MatVal(t.clone()) if is_mat(v) else t.clone()

    def _run_staged(self, stmts: List[N.Stmt], fr: Frame):
        """Execute a stageable statement run as one recording over the
        state it touches and the scalars it references (traced scalars in
        0-d static buffers).  The first execution warms up and captures;
        later ones with the same key replay.  A host read in the warm-up
        or a write to an unscanned state key leaves the run eager (the
        reference's blacklist); any other error raises."""
        key0 = (tuple(id(s) for s in stmts), fr.level)
        if key0 in self._stage_blacklist:
            self._exec_plan_aware(stmts, fr, None)
            return
        refs = set()
        for s in stmts:
            refs |= self._stmt_refs(s, fr.level)
        # stencil coefficients may read fields/globals (stencil-field
        # case, IR_StencilField.scala) — pull their refs in too
        for n in [n for n in refs if n in self.stencils]:
            for entry2 in self.stencils[n].values():
                if isinstance(entry2, tuple) and entry2 and entry2[0] == "__decl__":
                    for en in entry2[1].entries:
                        refs |= self._referenced_names(en.coef)
                elif isinstance(entry2, tuple) and entry2 and entry2[0] == "__sexpr__":
                    refs |= self._referenced_names(entry2[1].expr)

        def lookup(n):
            return fr.vars[n] if n in fr.vars else self.globals.get(n)

        def traceable(v):
            # ints are traced too (bool excluded: flags steer structural
            # control flow): a python-int iteration counter as a const
            # would re-key and re-capture the run every step (SWE's `it`)
            return (isinstance(v, (float, np.floating))
                    or (isinstance(v, (int, np.integer))
                        and not isinstance(v, bool))
                    or hasattr(v, "shape") or is_mat(v))

        var_names = sorted(
            n for n in refs
            if n not in self.fields and n not in self.stencils
            and (n in fr.vars or n in self.globals)
        )
        traced_names = tuple(n for n in var_names if traceable(lookup(n)))
        const_items = tuple(
            (n, repr(lookup(n))) for n in var_names if n not in traced_names
        )
        value_sigs = tuple(self._value_sig(lookup(n)) for n in traced_names)
        slot_snap = tuple(sorted(self.slot_index.items()))
        state_keys = tuple(sorted(
            k2 for k2 in self.state
            if k2[0] in refs or k2[0].split("__ghost")[0] in refs
        ))
        # staleness is part of the signature: a run captured while a field
        # was dead-store-elided rematerializes it inside the capture (and
        # vice versa).  Keys whose staleness is liveness-PROVEN unread
        # (every fast-path elision) cannot influence the run and are
        # excluded, so cycle 2+ replays cycle 1's capture (dsl/fastpath)
        stale_snap = tuple(sorted(
            k2 for k2 in self._stale
            if k2 in state_keys and k2 not in self._stale_proven
        ))
        key = (key0, traced_names, value_sigs, const_items, slot_snap, state_keys,
               stale_snap)
        entry = self._stage_cache.get(key)
        if entry is None:
            entry = self._stage_build(key0, stmts, fr, state_keys, traced_names, lookup)
            if entry is None:
                self._exec_plan_aware(stmts, fr, None)
                return
            self._stage_cache[key] = entry
        self._bind_state(state_keys, entry["static"])
        for buf, n in zip(entry["vars_in"], traced_names):
            self._load_value(buf, lookup(n))
        entry["rec"].replay()
        out = entry["out"]
        for k2, v in zip(entry["ghost_new"], out["ghosts"]):
            self.state[k2] = v.clone()
        for k2 in entry["stale_removed"]:
            self._stale.pop(k2, None)
        self._stale.update(entry["stale_added"])
        for n, v in zip(entry["out_var_names"], out["vars"]):
            fr.vars[n] = _clone_value(v)
        for n, v in zip(entry["out_glob_names"], out["globs"]):
            self.globals[n] = _clone_value(v)
        for n, v in entry["py_vars"]:
            fr.vars[n] = v
        for n, v in entry["py_globs"]:
            self.globals[n] = v
        self.slot_index = dict(entry["post_slots"])

    def _stage_build(self, key0, stmts, fr, state_keys, traced_names, lookup):
        """Warm up, bind and capture one staged run; None when it stays
        eager."""
        _MISSING = object()
        base_vars = dict(fr.vars)
        base_globals = dict(self.globals)
        entry = {
            "out_var_names": (), "out_glob_names": (),
            "py_vars": (), "py_globs": (),
            "post_slots": dict(self.slot_index),
            "stale_added": {}, "stale_removed": (),
            "ghost_new": (),
        }

        def fn(state_in, vars_in):
            prev = (self.state, self.globals, self.slot_index, self._in_trace,
                    self._stale)
            fr2 = Frame(dict(base_vars), fr.level)
            glob2 = dict(base_globals)
            for n, v in zip(traced_names, vars_in):
                if n in base_vars:
                    fr2.vars[n] = v
                else:
                    glob2[n] = v
            self.state = dict(zip(state_keys, state_in))
            self.globals = glob2
            self.slot_index = dict(prev[2])
            self._stale = dict(prev[4])
            self._in_trace = True
            self._frames.append(fr2)
            try:
                self._exec_plan_aware(stmts, fr2, None)
                extra = set(self.state) - set(state_keys)
                # ghost planes materialized for the first time inside
                # this run become additional outputs (the next execution
                # finds them in state_keys and captures once more)
                ghost_new = tuple(sorted(
                    k2 for k2 in extra if "__ghost" in k2[0]))
                extra -= set(ghost_new)
                if extra:
                    raise UnscannedWrite(f"staged run wrote unscanned fields {extra}")
                entry["ghost_new"] = ghost_new

                def is_traced(v):
                    return isinstance(v.data if is_mat(v) else v, torch.Tensor)

                var_changed = sorted(
                    n for n, v in fr2.vars.items()
                    if base_vars.get(n, _MISSING) is not v
                )
                glob_changed = sorted(
                    n for n, v in glob2.items()
                    if base_globals.get(n, _MISSING) is not v
                )
                entry["out_var_names"] = tuple(
                    n for n in var_changed if is_traced(fr2.vars[n]))
                entry["py_vars"] = tuple(
                    (n, fr2.vars[n]) for n in var_changed
                    if not is_traced(fr2.vars[n]))
                entry["out_glob_names"] = tuple(
                    n for n in glob_changed if is_traced(glob2[n]))
                entry["py_globs"] = tuple(
                    (n, glob2[n]) for n in glob_changed
                    if not is_traced(glob2[n]))
                entry["post_slots"] = dict(self.slot_index)
                entry["stale_added"] = {
                    k2: v for k2, v in self._stale.items() if k2 not in prev[4]
                }
                entry["stale_removed"] = tuple(
                    k2 for k2 in prev[4] if k2 not in self._stale
                )
                return (
                    tuple(self.state[k2] for k2 in state_keys),
                    tuple(fr2.vars[n] for n in entry["out_var_names"]),
                    tuple(glob2[n] for n in entry["out_glob_names"]),
                    tuple(self.state[k2] for k2 in ghost_new),
                )
            finally:
                self._frames.pop()
                (self.state, self.globals, self.slot_index, self._in_trace,
                 self._stale) = prev

        t0 = time.perf_counter()
        try:
            warm_up(lambda: fn([self.state[k2].clone() for k2 in state_keys],
                               [self._static_value(lookup(n)) for n in traced_names]),
                    self.device)
        except Exception as err:  # noqa: BLE001 — only the reference's cases stay eager
            if not is_host_read(err):
                raise
            self._leave_eager(key0, f"staged run of {len(stmts)} statements at level {fr.level} "
                                    f"({type(stmts[0]).__name__} first)", err)
            return None
        self.stage_stats.capture_s += time.perf_counter() - t0
        static = self._adopt(state_keys)
        vars_in = [self._static_value(lookup(n)) for n in traced_names]
        out = {}

        def run():
            state_out, var_out, glob_out, ghost_out = fn(static, vars_in)
            for buf, v in zip(static, state_out):
                if v is not buf:
                    buf.copy_(v)  # write back into the static state
            out.update(vars=var_out, globs=glob_out, ghosts=ghost_out)

        rec = Recording(run, self.device, self.stage_stats, self._recording_name("run", fr))
        rec.capture()
        entry.update(rec=rec, static=static, vars_in=vars_in, out=out)
        return entry

    # ------------------------------------------------------------------
    # early-exit `repeat N times` as ONE device loop
    #
    # The generated CG coarse solves look like
    #   repeat 512 times count it { ...; if (res <= eps) { return }; ... }
    # The conditional `return` makes the loop unstageable, so without
    # this lowering it runs eagerly with a host read per iteration.  Here
    # the whole loop becomes a device loop (runtime/staging.device_loop,
    # the counterpart of the reference's lax.while_loop) whose carry holds
    # the touched field state and the mutated scalars; the function-level
    # early return needs ONE host read after the loop.

    def _exec_repeat_early_exit(self, s: N.RepeatTimes, fr: Frame, parts):
        """Returns "return" (early exit taken — caller raises _Return),
        True (loop completed), or False (run it eagerly)."""
        key0 = ("__ee__", id(s), fr.level)
        if key0 in self._stage_blacklist:
            return False
        sig = self._ee_signature(s, fr)
        if sig is None:
            return False
        traced_names, const_items, state_keys, lookup = sig
        n = int(self.eval_expr(s.count, fr, None))
        slot_snap = tuple(sorted(self.slot_index.items()))
        value_sigs = tuple(self._value_sig(lookup(nm)) for nm in traced_names)
        key = (key0, n, traced_names, value_sigs, const_items, slot_snap, state_keys)
        entry = self._stage_cache.get(key)
        if entry is None:
            base_vars, base_globals = dict(fr.vars), dict(self.globals)

            def loop(state_in, vars_in):
                return self._ee_while(s, parts, n, state_keys, traced_names,
                                      base_vars, base_globals, fr.level, state_in, vars_in)

            t0 = time.perf_counter()
            try:
                warm_up(lambda: loop([self.state[k2].clone() for k2 in state_keys],
                                     [self._static_value(lookup(nm)) for nm in traced_names]),
                        self.device)
            except Exception as err:  # noqa: BLE001 — only the reference's cases stay eager
                if not is_host_read(err):
                    raise
                self._leave_eager(key0, f"early-exit repeat at level {fr.level}", err)
                return False
            self.stage_stats.capture_s += time.perf_counter() - t0
            static = self._adopt(state_keys)
            vars_in = [self._static_value(lookup(nm)) for nm in traced_names]
            out = {}

            def run():
                state_out, vars_out, it_out, done = loop(static, vars_in)
                for buf, v in zip(static, state_out):
                    if v is not buf:
                        buf.copy_(v)
                for buf, v in zip(vars_in, vars_out):
                    self._load_value(buf, v)
                out.update(it=it_out, done=done)

            rec = Recording(run, self.device, self.stage_stats, self._recording_name("loop", fr))
            rec.capture()
            entry = {"rec": rec, "static": static, "vars_in": vars_in, "out": out}
            self._stage_cache[key] = entry
        self._bind_state(state_keys, entry["static"])
        for buf, nm in zip(entry["vars_in"], traced_names):
            self._load_value(buf, lookup(nm))
        entry["rec"].replay()
        for nm, buf in zip(traced_names, entry["vars_in"]):
            (fr.vars if nm in fr.vars else self.globals)[nm] = _clone_value(buf)
        if s.count_var is not None:
            fr.vars[s.count_var] = entry["out"]["it"].clone()
        if _never_exits(parts[1]):
            return True  # the large repeat: nothing to read
        return "return" if read_flag(entry["out"]["done"], self.stage_stats) else True

    def _exec_repeat_early_exit_traced(self, s: N.RepeatTimes, fr: Frame, parts):
        """The device loop inline, inside a staged run: only reachable in
        tail position (enforced by _fn_stageable), where the early
        `return` is a loop break — no host read inside the run.  In a
        capture the loop ends the current graph segment and the next one
        starts after it."""
        sig = self._ee_signature(s, fr)
        if sig is None:
            raise UnscannedWrite("early-exit repeat with a matrix-valued carry")
        traced_names, _const, state_keys, lookup = sig
        n = int(self.eval_expr(s.count, fr, None))
        state_in = [self.state[k2] for k2 in state_keys]
        vars_in = [self._device_value(lookup(nm)) for nm in traced_names]
        state_out, vars_out, it_out, _done = self._ee_while(
            s, parts, n, state_keys, traced_names,
            dict(fr.vars), dict(self.globals), fr.level, state_in, vars_in)
        for k2, v in zip(state_keys, state_out):
            self.state[k2] = v
        for nm, v in zip(traced_names, vars_out):
            if nm in fr.vars:
                fr.vars[nm] = v
            else:
                self.globals[nm] = v
        if s.count_var is not None:
            fr.vars[s.count_var] = it_out

    def _ee_while(self, s, parts, n, state_keys, traced_names,
                  base_vars, base_globals, level, state_in, vars_in):
        """The loop of `repeat n times { pre; if cond {return}; post }` on
        the device: returns (state, vars, iterations, done)."""
        pre, cond_expr, post = parts
        exits = not _never_exits(cond_expr)
        vars_in = [self._device_value(v) for v in vars_in]  # no matrix: _ee_signature
        vdtypes = [v.dtype for v in vars_in]
        nk = len(state_keys)

        def as_dtype(v, dt):
            return self._device_value(v).to(dt)

        def run_once(carry, it):
            state_t, vars_t = carry[:nk], carry[nk:]
            prev = (self.state, self.globals, self.slot_index, self._in_trace)
            fr2 = Frame(dict(base_vars), level)
            glob2 = dict(base_globals)
            for nm, v in zip(traced_names, vars_t):
                if nm in base_vars:
                    fr2.vars[nm] = v
                else:
                    glob2[nm] = v
            if s.count_var is not None:
                fr2.vars[s.count_var] = it
            self.state = dict(zip(state_keys, state_t))
            self.globals = glob2
            self.slot_index = dict(prev[2])
            self._in_trace = True
            # the loop's updates are masked against the carry (and post's
            # against the state after pre): in-place kernels clone first
            n_pinned = len(self._pinned)
            self._pinned.append(list(state_t))
            try:
                for st in pre:
                    self.exec_stmt(st, fr2, None)
                done2 = None
                if exits:
                    done2 = self._device_value(self.eval_expr(cond_expr, fr2, None)).to(torch.bool)
                # post executes only when not exiting: compute, then
                # select back the pre-post values on exit
                snap_state = dict(self.state)
                snap_vars = dict(fr2.vars)
                snap_glob = dict(glob2)
                self._pinned.append(list(snap_state.values()))
                for st in post:
                    self.exec_stmt(st, fr2, None)
                extra = set(self.state) - set(state_keys)
                if extra:
                    raise UnscannedWrite(
                        f"early-exit loop wrote unscanned fields {extra}")
                # select back pre-post values on exit, but only for
                # fields `post` actually wrote (identity check) — the
                # select is a full-array copy per iteration otherwise
                new_state = [
                    self.state[k2] if done2 is None or self.state[k2] is snap_state[k2]
                    else torch.where(done2, snap_state[k2], self.state[k2])
                    for k2 in state_keys
                ]
                new_vars = []
                for nm, dt in zip(traced_names, vdtypes):
                    if nm in base_vars:
                        a, b = snap_vars.get(nm), fr2.vars.get(nm)
                    else:
                        a, b = snap_glob.get(nm), glob2.get(nm)
                    b = as_dtype(b, dt)
                    new_vars.append(b if done2 is None or a is b
                                    else torch.where(done2, as_dtype(a, dt), b))
                return new_state + new_vars, done2
            finally:
                del self._pinned[n_pinned:]
                (self.state, self.globals, self.slot_index,
                 self._in_trace) = prev

        carry, it, done = device_loop(list(state_in) + vars_in, run_once, n, exits=exits)
        vars_out = [py_float(c) if is_py_float(v) and c.dtype == torch.float64 else c
                    for c, v in zip(carry[nk:], vars_in)]
        return carry[:nk], vars_out, it, done
