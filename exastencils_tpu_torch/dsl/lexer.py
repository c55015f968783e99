"""Tokenizer for ExaSlang layer-4 source (.exa4).

Copied from exastencils_tpu/dsl/lexer.py so that the PyTorch port imports
nothing of the JAX package; imports point at exastencils_tpu_torch.

Reference grammar: parsers/l4/L4_Parser.scala (682 LoC, Scala parser
combinators over StdLexical).  Token classes: identifiers, integer/real
literals (incl. 1.0E-10), single/double-quoted strings, and the operator
set used by the L4 grammar.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, List, Optional

KEYWORDS = {
    "import", "Domain", "Layout", "Field", "Stencil", "StencilField", "external",
    "Function", "FunctionTemplate", "Instantiate", "Globals", "Var", "Val", "Expr",
    "if", "else", "repeat", "until", "while", "times", "count", "with", "contraction",
    "loop", "over", "fragments", "blocks", "sequentially", "where", "starting",
    "ending", "stepping", "reduction", "communicate", "communicating", "begin",
    "finish", "apply", "bc", "to", "advance", "return", "break", "color",
    "solve", "locally", "jacobi", "relax", "from", "and", "but", "all", "not",
    "only", "on", "boundary", "ghost", "dup", "inner", "of", "levels",
    "LayoutTransformations", "Knowledge", "noinline",
}

# multi-char operators first (elementwise matrix ops .* ./ .^ .% come
# from the reference's matrix grammar, parsers/l4 matrix productions)
_OPS = [
    ".*", "./", ".^", ".%",
    "**", "==", "!=", "<=", ">=", "&&", "||", "+=", "-=", "*=", "/=", "=>",
    ":=", "++", "--", "%", "+", "-", "*", "/", "(", ")", "[", "]", "{", "}",
    "<", ">", ",", "=", "@", ":", ";", "!", ".",
]
_OP_RE = "|".join(re.escape(o) for o in _OPS)

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<imag>((\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?)j(?![\w]))
  | (?P<real>(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)(?!\w)|\d+\.\d*|\.\d+)
  | (?P<int>\d+)
  | (?P<string>"[^"]*"|'[^']*')
  | (?P<ident>\\[A-Za-z]+(_\{[A-Za-z]+\})?|[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>%s)
""" % _OP_RE,
    re.VERBOSE | re.DOTALL,
)


@dataclass(frozen=True)
class Token:
    kind: str  # 'ident' | 'keyword' | 'int' | 'real' | 'string' | 'op' | 'eof'
    value: str
    line: int
    col: int

    def __repr__(self):
        return f"{self.kind}:{self.value!r}@{self.line}"


def tokenize(src: str, filename: str = "<l4>") -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    line = 1
    line_start = 0
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(
                f"{filename}:{line}: cannot tokenize {src[pos:pos+20]!r}"
            )
        kind = m.lastgroup
        text = m.group()
        if kind in ("ws", "comment"):
            nl = text.count("\n")
            if nl:
                line += nl
                line_start = m.end() - (len(text) - text.rfind("\n") - 1)
        else:
            col = m.start() - line_start + 1
            if kind == "ident" and text in KEYWORDS:
                tokens.append(Token("keyword", text, line, col))
            elif kind == "string":
                tokens.append(Token("string", text[1:-1], line, col))
            elif kind == "imag":
                # complex literal `0.5j` (ComplexNumbers suites)
                tokens.append(Token("imag", text[:-1], line, col))
            else:
                tokens.append(Token(kind, text, line, col))
        pos = m.end()
    tokens.append(Token("eof", "", line, 0))
    return tokens


class TokenStream:
    def __init__(self, tokens: List[Token], filename: str = "<l4>"):
        self.toks = tokens
        self.i = 0
        self.filename = filename

    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def peek(self, ahead: int = 1) -> Token:
        j = min(self.i + ahead, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.cur
        if t.kind != "eof":
            self.i += 1
        return t

    def at(self, kind: str, value: Optional[str] = None) -> bool:
        t = self.cur
        return t.kind == kind and (value is None or t.value == value)

    def at_value(self, *values: str) -> bool:
        return self.cur.value in values and self.cur.kind in ("keyword", "op", "ident")

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        if self.at(kind, value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        if not self.at(kind, value):
            t = self.cur
            raise SyntaxError(
                f"{self.filename}:{t.line}:{t.col}: expected "
                f"{value or kind}, got {t.kind} {t.value!r}"
            )
        return self.next()
