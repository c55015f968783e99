"""ExaSlang-2 frontend: "discrete" layer (fields/stencils/equations on
levels, no algorithms).

Copied from exastencils_tpu/dsl/l2.py so that the PyTorch port imports
nothing of the JAX package; imports point at exastencils_tpu_torch.

Reference counterparts: parsers/l2 grammar, node packages
{base,field,operator,grid}/l2 and app/l2/L2_LayerHandler.scala:88-139;
the L2->L3 progression is structural (declarations carry over), so both
layers share the L3Program container here.

Surface covered (from Examples/*/*.exa2):
  global< [0,0] to [1,1] >                       (domain, keyword-less)
  Solution with Real on Node of global = 0.0     (field)
  Solution on boundary = <expr> | Neumann        (bc)
  Laplace from Stencil { [off] => coef ... }     (operator)
  SolEq { Laplace * Solution == RHS }            (equation, keyword-less)
plus the keyworded `Domain/Field/Operator/Equation/Globals/Knowledge`
forms that the Stokes/NS examples use.
"""

from __future__ import annotations

import os
from typing import Optional

from exastencils_tpu_torch.dsl import nodes as N
from exastencils_tpu_torch.dsl.l3 import L3Parser, L3Program


class L2Parser(L3Parser):
    def parse_l2_program(self, base: str = ".") -> L3Program:
        prog = L3Program()
        ts = self.ts
        while not ts.at("eof"):
            v = ts.cur.value
            if ts.accept("keyword", "import"):
                path = ts.expect("string").value
                prog.merge(parse_l2_file(os.path.join(base, path)))
            elif v == "Domain":
                prog.domains.append(self.parse_domain())
            elif v == "Field":
                ts.next()
                prog.fields.append(self.parse_l3_field())
            elif v == "Operator":
                ts.next()
                prog.operators.append(self.parse_operator())
            elif v == "Equation":
                ts.next()
                prog.equations.append(self.parse_equation())
            elif v == "Globals":
                prog.globals_.extend(self.parse_globals())
            elif v == "Knowledge":
                prog.inline_knowledge.update(self.parse_inline_knowledge())
            elif v == "generate":
                self.parse_generate(prog)
            elif v == "override":
                prog.bc_overrides.append(self.parse_override_bc())
            elif ts.cur.kind in ("ident", "keyword"):
                self._parse_bare_decl(prog)
            else:
                raise self.err("unexpected L2 top-level construct")
        return prog

    def _parse_bare_decl(self, prog: L3Program):
        """Keyword-less L2 declarations, dispatched on the token after
        the introducing identifier."""
        ts = self.ts
        name = ts.next().value
        nxt = ts.cur
        if nxt.kind == "op" and nxt.value == "<":
            # domain: `name< [lo] to [hi] >`
            ts.next()
            lower = self.parse_number_list()
            ts.expect("keyword", "to")
            upper = self.parse_number_list()
            ts.expect("op", ">")
            prog.domains.append(N.DomainDecl(name, lower, upper))
            return
        if nxt.kind == "op" and nxt.value == "{":
            prog.equations.append(self.parse_equation(name=name))
            return
        if nxt.value == "from":
            ts.next()
            if ts.at("ident", "default"):
                ts.next()
                kind = ts.next().value
                ts.expect("keyword", "on")
                loc = ts.next().value
                ts.expect("keyword", "with")
                interp = ts.expect("string").value
                prog.operators.append(N.StencilFromDefault(name, kind, loc, interp))
                return
            if ts.at("keyword", "Stencil"):
                ts.next()
                prog.operators.append(self._parse_stencil_body(name, None))
                return
            # `Residual from Solution` field clone
            from exastencils_tpu_torch.dsl.l3 import L3FieldDecl

            decl = L3FieldDecl(name)
            decl.from_field = ts.expect("ident").value
            prog.fields.append(decl)
            return
        # field decl: `name [@lvl] with dtype on loc of dom [= init]`
        # or bc decl: `name [@lvl] on boundary = expr`
        prog.fields.append(self.parse_l3_field(name=name))

    def parse_equation(self, name: Optional[str] = None):
        # L2 equations may omit the `==`'s rhs onto multiple lines; the
        # base implementation already parses `{ lhs == rhs }`.
        return super().parse_equation(name=name)


def parse_l2_file(path: str) -> L3Program:
    with open(path) as f:
        src = f.read()
    return L2Parser(src, path).parse_l2_program(
        base=os.path.dirname(os.path.abspath(path))
    )


def parse_l2(src_or_path: str) -> L3Program:
    if os.path.exists(src_or_path):
        return parse_l2_file(src_or_path)
    return L2Parser(src_or_path).parse_l2_program()
