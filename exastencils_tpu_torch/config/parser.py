"""key=value config parser for `.knowledge` / `.settings` / `.platform` files.

Copied from exastencils_tpu/config/parser.py so that the PyTorch port imports
nothing of the JAX package; imports point at exastencils_tpu_torch.

Format-compatible with the reference's reflective parser
(parsers/config/Settings_Parser.scala:31-71) including:
  * `//` comments
  * `import '<relative path>'` composition (reference
    Utilities/config_from_knowledge.py behavior)
  * strings ("..."), booleans, ints, floats, and `{a, b}` lists
  * `+=` list append
Values are applied via the target object's `.set(key, value)`
(the UniversalSetter analog, core/UniversalSetter.scala).
"""

from __future__ import annotations

import os
import re
from typing import Any

_IMPORT_RE = re.compile(r"""^\s*import\s+['"](?P<path>[^'"]+)['"]\s*$""")
_ASSIGN_RE = re.compile(r"""^\s*(?P<key>[A-Za-z_][A-Za-z0-9_]*)\s*(?P<op>\+?=)\s*(?P<val>.+?)\s*$""")


def parse_value(tok: str) -> Any:
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    if tok.startswith("'") and tok.endswith("'"):
        return tok[1:-1]
    if tok.startswith("{") and tok.endswith("}"):
        inner = tok[1:-1].strip()
        if not inner:
            return []
        return [parse_value(t) for t in inner.split(",")]
    if tok.startswith("(") and tok.endswith(")"):
        inner = tok[1:-1].strip()
        if not inner:
            return ()
        return tuple(parse_value(t) for t in inner.split(","))
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


def _strip_comment(line: str) -> str:
    # avoid cutting "//" inside string literals
    out = []
    in_str = None
    i = 0
    while i < len(line):
        c = line[i]
        if in_str:
            if c == in_str:
                in_str = None
            out.append(c)
        elif c in "\"'":
            in_str = c
            out.append(c)
        elif c == "/" and i + 1 < len(line) and line[i + 1] == "/":
            break
        elif c == "#":
            break
        else:
            out.append(c)
        i += 1
    return "".join(out)


def parse_config_file(path: str, target) -> None:
    """Parse `path`, applying `key = value` lines to `target.set(...)`.

    `import` lines are resolved relative to the importing file and parsed
    first (later assignments override earlier ones, matching the
    reference's file-concatenation semantics)."""
    with open(path) as f:
        text = f.read()
    base = os.path.dirname(os.path.abspath(path))
    parse_config_text(text, target, base=base)


_BLOCK_COMMENT_RE = re.compile(r"/\*.*?\*/", re.DOTALL)


def _strip_block_comments(text: str) -> str:
    """Remove /* ... */ preserving line structure (a comment is replaced
    by the newlines it spanned, so `key1 = a /* ...\n... */` never
    splices the next statement onto the same line) and skipping matches
    inside string literals."""
    out = []
    i = 0
    in_str = None
    n = len(text)
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == in_str:
                in_str = None
            i += 1
        elif c in "\"'":
            in_str = c
            out.append(c)
            i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            end = text.find("*/", i + 2)
            if end < 0:
                break  # unterminated comment: drop the rest
            out.append("\n" * text.count("\n", i, end + 2))
            i = end + 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_config_text(text: str, target, base: str = ".") -> None:
    text = _strip_block_comments(text)
    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line:
            continue
        m = _IMPORT_RE.match(line)
        if m:
            parse_config_file(os.path.join(base, m.group("path")), target)
            continue
        m = _ASSIGN_RE.match(line)
        if not m:
            raise ValueError(f"cannot parse config line: {raw!r}")
        key, op, val = m.group("key"), m.group("op"), parse_value(m.group("val"))
        if op == "+=":
            cur = getattr(target, key, None) if hasattr(target, key) else None
            if isinstance(cur, list):
                cur.append(val)
                continue
        target.set(key, val)
