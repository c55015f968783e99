"""Whole-program field liveness for the L4 fast path.

Reference: exastencils_tpu/dsl/liveness.py (the same code, on the
port's own AST nodes and DirichletBC).

The fused down leg (pre-smooth + residual + restriction in one
memory pass, dsl/fastpath.py) never materializes the residual field the
source program writes (`CalcRes`: loop over Res { Res = F - A*U }).
Eliding that store is only legal if the residual's *interior* is dead:
overwritten before any read on every continuation of the transformed
program.  This module proves exactly that — an interprocedural
read-before-kill analysis over the L4 AST.

This is the analog of the dependence analysis the reference runs before
rewriting loop nests (polyhedron/IR_PolyOpt.scala:357 computes RAW/WAR/
WAW dependences before transforming; dead-code elimination at :425) —
here specialized to whole-field def/use chains across functions.

Terminology: a statement's first access to a (field, level) key is
  'read'  — the key's interior may be read,
  'kill'  — the key's interior is certainly overwritten first,
  'none'  — the key is untouched,
  'stop'  — control certainly leaves the block (unconditional return).
"kill" means INTERIOR overwrite only: the fast path's elision leaves
the boundary ring untouched (identical to what the plain path leaves
there after `apply bc`), so boundary liveness never matters.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

from exastencils_tpu_torch.core.field import DirichletBC
from exastencils_tpu_torch.dsl import nodes as N

Key = Tuple[str, int]  # (field name, level)

READ, KILL, NONE, STOP = "read", "kill", "none", "stop"


class FieldLiveness:
    """Liveness queries against one L4Executable's program.

    `ignore` (set of stmt ids, plus the level they are instantiated at)
    marks the statements the fast path REPLACES: for the key being
    queried they neither read nor write — the query runs against the
    transformed program, not the source.
    """

    def __init__(self, exe):
        self.exe = exe
        self._sites: Dict[Tuple[str, Optional[int]], List] = {}
        self._index_call_sites()

    # ------------------------------------------------------------------
    # public query
    def interior_dead_after(
        self,
        fn_name: str,
        fn_level: Optional[int],
        body: List[N.Stmt],
        pos: int,
        key: Key,
        ignore_ids: FrozenSet[int],
        ignore_level: int,
    ) -> bool:
        """True when key's interior is written before any read on every
        continuation after body[pos] of function fn_name@fn_level."""
        self._memo: Dict[Tuple, str] = {}
        self._ignore = (ignore_ids, ignore_level)
        fa = self._first_access(body[pos + 1:], fn_level, key)
        if fa == READ:
            return False
        if fa == KILL:
            return True
        return self._dead_after_return(fn_name, fn_level, key, set())

    # ------------------------------------------------------------------
    # call-site index: (callee name, callee level) -> list of
    # (caller body, path) where path = [(container stmt|None, stmts,
    # idx), ...] root-first, caller level baked into resolved entries
    def _index_call_sites(self):
        for (fname, flvl), decl in self.exe.functions.items():
            self._walk_sites(decl.body, flvl, [], (fname, flvl))

    def _walk_sites(self, stmts, level, path_prefix, caller):
        for idx, s in enumerate(stmts):
            frame = path_prefix + [(stmts, idx)]
            for call in self._calls_of_stmt(s):
                for tgt, tl in (self.exe._call_targets(call, level) or []):
                    self._sites.setdefault((tgt.name, tl), []).append(
                        (caller, list(frame)))
            for sub in self._sub_blocks(s):
                self._walk_sites(sub, level, frame, caller)

    @staticmethod
    def _sub_blocks(s):
        if isinstance(s, N.If):
            return [s.then_body, s.else_body]
        if isinstance(s, (N.RepeatTimes, N.RepeatUntil, N.LoopOverField,
                          N.LoopOverFragments, N.ColorWith, N.RepeatWith,
                          N.LevelScope)):
            return [s.body]
        return []

    def _calls_of_stmt(self, s):
        out = []

        def expr(e):
            if isinstance(e, N.Call):
                if any(k[0] == e.name for k in self.exe.functions):
                    out.append(e)
                for a in e.args:
                    expr(a)
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

        if isinstance(s, N.VarDecl):
            expr(s.init)
        elif isinstance(s, N.Assign):
            expr(s.value)
        elif isinstance(s, N.If):
            expr(s.cond)
        elif isinstance(s, N.RepeatTimes):
            expr(s.count)
        elif isinstance(s, N.RepeatUntil):
            expr(s.cond)
        elif isinstance(s, N.ExprStmt):
            expr(s.expr)
        elif isinstance(s, N.Return):
            expr(s.value)
        return out

    # ------------------------------------------------------------------
    def _dead_after_return(self, fname, flevel, key, seen) -> bool:
        """Dead when (fname, flevel) returns, on every in-program call
        site's continuation.  Coinductive on cycles: a read must occur
        at some finite point, and every finite path is scanned."""
        fk = (fname, flevel)
        if fk in seen:
            return True
        seen = seen | {fk}
        sites = self._sites.get(fk, [])
        if not sites:
            # entry function (Application / an externally driven
            # function): closed-world — nothing in the program runs
            # afterwards.  External .state peeks are served by
            # get_field's stale-materialization (dsl/fastpath.py).
            return True
        for (caller, path) in sites:
            cname, clevel = caller
            ok_here = None
            for (stmts, idx) in reversed(path):
                # scan from the containing statement itself: after the
                # callee returns, the rest of that statement and the
                # rest of the block may access the key
                fa = self._first_access(stmts[idx:], clevel, key)
                if fa == READ:
                    return False
                if fa == KILL:
                    ok_here = True
                    break
                # loop containers may iterate again from their top
                cont = self._container_of(caller, stmts)
                if cont is not None and isinstance(
                    cont, (N.RepeatTimes, N.RepeatUntil, N.LoopOverField,
                           N.ColorWith, N.RepeatWith)
                ):
                    if self._first_access(cont.body, clevel, key) == READ:
                        return False
            if ok_here:
                continue
            if not self._dead_after_return(cname, clevel, key, seen):
                return False
        return True

    def _container_of(self, caller, stmts):
        """The statement whose body is `stmts` (None for the body root).
        Identity search over the caller's declaration tree."""
        decl = self.exe.functions.get(caller)
        if decl is None or decl.body is stmts:
            return None
        found = [None]

        def walk(s):
            for sub in self._sub_blocks(s):
                if sub is stmts:
                    found[0] = s
                    return True
                for x in sub:
                    if walk(x):
                        return True
            return False

        for x in decl.body:
            if walk(x):
                break
        return found[0]

    # ------------------------------------------------------------------
    # first access of a statement list
    def _first_access(self, stmts, level, key) -> str:
        for s in stmts:
            r = self._stmt_access(s, level, key)
            if r in (READ, KILL):
                return r
            if r == STOP:
                return NONE
        return NONE

    def _resolve(self, spec, level):
        try:
            if spec is None:
                return level
            lv = spec.resolve(self.exe.lo, self.exe.hi, level)
            return lv[0] if isinstance(lv, list) and len(lv) == 1 else lv
        except Exception:
            return None  # unresolvable: caller treats as "may match"

    def _is_key_access(self, e: N.Access, level, key) -> bool:
        if e.name != key[0]:
            return False
        lv = self._resolve(e.level, level)
        if isinstance(lv, list):
            return key[1] in lv
        return lv is None or lv == key[1]

    def _expr_reads(self, e, level, key) -> bool:
        if e is None or isinstance(e, (N.Num, N.Str)):
            return False
        if isinstance(e, N.Access):
            if self._is_key_access(e, level, key):
                return True
            # a stencil whose coefficients reference the key field
            # reads it on every application (stencil-field case)
            return e.name in self._stencils_reading(key[0])
        if isinstance(e, N.UnOp):
            return self._expr_reads(e.operand, level, key)
        if isinstance(e, N.BinOp):
            return (self._expr_reads(e.lhs, level, key)
                    or self._expr_reads(e.rhs, level, key))
        if isinstance(e, N.MatrixLit):
            return any(self._expr_reads(x, level, key)
                       for row in e.rows for x in row)
        if isinstance(e, N.TensorLit):
            return any(self._expr_reads(x, level, key) for _, x in e.entries)
        if isinstance(e, N.Call):
            if any(self._expr_reads(a, level, key) for a in e.args):
                return True
            targets = self.exe._call_targets(e, level)
            if targets is None:
                return True  # unresolvable call: assume it reads
            for fn, lvl in targets:
                if self._summary(fn, lvl, key) == READ:
                    return True
            return False
        return True  # unknown expression kind: assume it reads

    def _stencils_reading(self, field_name):
        cache = getattr(self, "_sten_read_cache", None)
        if cache is None:
            cache = self._sten_read_cache = {}
        if field_name not in cache:
            names = set()
            for sname, per_level in self.exe.stencils.items():
                for entry in per_level.values():
                    if isinstance(entry, tuple) and entry \
                            and entry[0] in ("__decl__", "__sexpr__"):
                        node = entry[1]
                        refs = set()
                        if entry[0] == "__decl__":
                            for en in node.entries:
                                refs |= self.exe._referenced_names(en.coef)
                        else:
                            refs |= self.exe._referenced_names(node.expr)
                        if field_name in refs:
                            names.add(sname)
            cache[field_name] = names
        return cache[field_name]

    def _summary(self, fn: N.FunctionDecl, level, key) -> str:
        mk = ("summary", id(fn), level, key)
        if mk in self._memo:
            return self._memo[mk]
        self._memo[mk] = READ  # conservative on recursion cycles
        r = self._first_access(fn.body, level, key)
        self._memo[mk] = r
        return r

    # ------------------------------------------------------------------
    def _stmt_access(self, s, level, key) -> str:
        ids, ilvl = self._ignore
        if id(s) in ids and level == ilvl:
            return NONE  # a statement the fast path replaces
        if isinstance(s, N.VarDecl):
            return READ if self._expr_reads(s.init, level, key) else NONE
        if isinstance(s, N.Assign):
            t = s.target
            if t.name in self.exe.fields and self._is_key_access(t, level, key):
                if s.op == "=" and not self._expr_reads(s.value, level, key) \
                        and not t.component and not t.slot:
                    return KILL  # whole-field overwrite outside a loop
                return READ
            return READ if self._expr_reads(s.value, level, key) else NONE
        if isinstance(s, N.If):
            if self._expr_reads(s.cond, level, key):
                return READ
            rt = self._first_access(s.then_body, level, key)
            re_ = self._first_access(s.else_body, level, key)
            if READ in (rt, re_):
                return READ
            if rt == KILL and re_ == KILL:
                return KILL
            return NONE
        if isinstance(s, N.RepeatTimes):
            if self._expr_reads(s.count, level, key):
                return READ
            r = self._first_access(s.body, level, key)
            if r == READ:
                return READ
            if r == KILL:
                try:
                    n = int(self.exe._eval_const(s.count))
                    if n >= 1:
                        return KILL
                except Exception:
                    pass
            return NONE
        if isinstance(s, N.RepeatUntil):
            if self._expr_reads(s.cond, level, key):
                return READ
            return READ if self._first_access(s.body, level, key) == READ else NONE
        if isinstance(s, N.LevelScope):
            lv = self._resolve(s.levels, level)
            active = (lv is None or lv == level
                      or (isinstance(lv, list) and level in lv))
            return self._stmt_list_cond(s.body, level, key) if active else NONE
        if isinstance(s, (N.LoopOverFragments,)):
            return self._first_access(s.body, level, key)
        if isinstance(s, (N.ColorWith, N.RepeatWith)):
            # masked execution: writes are partial (never a kill)
            conds = ([s.colors] + list(s.more_colors)
                     if isinstance(s, N.ColorWith) else s.conditions)
            if any(self._expr_reads(c, level, key) for c in conds):
                return READ
            return READ if self._block_reads(s.body, level, key) else NONE
        if isinstance(s, N.LoopOverField):
            if s.condition is not None and self._expr_reads(s.condition, level, key):
                return READ
            lvl = self._resolve(s.field.level, level)
            same_field = (s.field.name == key[0] and lvl == key[1])
            # canonical interior kill: `loop over K { K = expr }` with
            # an unmasked default region and a key-free rhs
            if (same_field and s.condition is None and s.region is None
                    and not s.on_boundary and not s.stepping
                    and not s.starting and not s.ending
                    and len(s.body) == 1 and isinstance(s.body[0], N.Assign)):
                a = s.body[0]
                if (a.target.name == key[0]
                        and self._resolve(a.target.level, level) == key[1]
                        and a.op == "=" and not a.target.component
                        and not a.target.slot and not a.target.offset
                        and not self._expr_reads(a.value, level, key)):
                    return KILL
            return READ if self._block_reads(s.body, level, key) else NONE
        if isinstance(s, N.Communicate):
            return NONE  # value-preserving (sharding pin / halo refresh)
        if isinstance(s, N.ApplyBC):
            if s.field.name == key[0] \
                    and self._resolve(s.field.level, level) == key[1]:
                bc = self.exe.fields[key[0]].bc_by_level.get(key[1])
                # Dirichlet rewrites the boundary ring from constants /
                # coordinates only; every other bc reads the interior
                return NONE if isinstance(bc, DirichletBC) else READ
            return NONE
        if isinstance(s, N.Advance):
            return READ if s.field.name == key[0] else NONE
        if isinstance(s, N.Return):
            if self._expr_reads(s.value, level, key):
                return READ
            return STOP
        if isinstance(s, N.Break):
            return STOP
        if isinstance(s, N.ExprStmt):
            e = s.expr
            if isinstance(e, N.Call):
                targets = self.exe._call_targets(e, level)
                if targets:
                    if any(self._expr_reads(a, level, key) for a in e.args):
                        return READ
                    rs = [self._summary(fn, lvl, key) for fn, lvl in targets]
                    if READ in rs:
                        return READ
                    if rs and all(r == KILL for r in rs):
                        return KILL
                    return NONE
            return READ if self._expr_reads(e, level, key) else NONE
        if isinstance(s, (N.SolveLocally, N.SolveMatSys)):
            return READ if key[0] in self.exe._stmt_refs(s, level) else NONE
        return READ  # unknown statement kind: assume it reads

    def _stmt_list_cond(self, stmts, level, key) -> str:
        """Body of a conditionally-entered scope: kills don't count."""
        r = self._first_access(stmts, level, key)
        return READ if r == READ else NONE

    def _block_reads(self, stmts, level, key) -> bool:
        """Any read anywhere in a nested block (ignores kill ordering —
        conservative for bodies executed under masks)."""
        for s in stmts:
            r = self._stmt_access(s, level, key)
            if r == READ:
                return True
        return False
