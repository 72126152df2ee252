"""Minimal HCL1 parser (reference: jobspec/parse.go consumes
hashicorp/hcl). Covers the subset Nomad jobspecs use:

  attribute   key = value
  block       name "label" ... { body }
  values      string, number, bool, list, object, heredoc (<<EOF, <<-EOF)
  comments    #, //, /* */

The parse result is a Body tree: attrs {key: value} plus an ordered list
of (name, labels, Body) blocks. ${...} interpolations inside strings are
preserved verbatim (they are resolved later, at task-env build time).

The counterpart of `nomad_tpu.jobspec.hcl`.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class HCLParseError(ValueError):
    def __init__(self, msg: str, line: int):
        super().__init__(f"line {line}: {msg}")
        self.line = line


# ------------------------------------------------------------------ lexer
_TOKEN_RE = re.compile(r"""
    (?P<ws>[ \t\r]+)
  | (?P<nl>\n)
  | (?P<comment>\#[^\n]*|//[^\n]*)
  | (?P<mcomment>/\*.*?\*/)
  | (?P<heredoc><<-?(?P<hdtag>[A-Za-z_][A-Za-z0-9_]*)\n)
  | (?P<string>"(?:\\.|[^"\\])*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.-]*)
  | (?P<punct>[{}\[\],=])
""", re.VERBOSE | re.DOTALL)


@dataclass
class _Tok:
    kind: str
    value: Any
    line: int


def _lex(text: str) -> List[_Tok]:
    toks: List[_Tok] = []
    pos, line = 0, 1
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise HCLParseError(f"unexpected character {text[pos]!r}", line)
        kind = m.lastgroup
        raw = m.group(0)
        if kind == "heredoc":
            tag = m.group("hdtag")
            strip_indent = raw.startswith("<<-")
            line += 1
            end_re = re.compile(
                rf"^[ \t]*{re.escape(tag)}[ \t]*$", re.MULTILINE)
            em = end_re.search(text, m.end())
            if em is None:
                raise HCLParseError(f"unterminated heredoc <<{tag}", line)
            body = text[m.end():em.start()]
            if body.endswith("\n"):
                body = body[:-1]      # the newline before the EOF marker
            if strip_indent:
                body = "\n".join(l.lstrip("\t ") for l in body.split("\n"))
            toks.append(_Tok("string", body, line))
            line += body.count("\n") + 1
            pos = em.end()
            continue
        if kind == "nl":
            line += 1
        elif kind == "mcomment":
            line += raw.count("\n")
        elif kind == "string":
            s = raw[1:-1]
            s = (s.replace(r"\\", "\x00")
                  .replace(r"\"", '"')
                  .replace(r"\n", "\n")
                  .replace(r"\t", "\t")
                  .replace("\x00", "\\"))
            toks.append(_Tok("string", s, line))
        elif kind == "number":
            toks.append(_Tok("number",
                             float(raw) if "." in raw else int(raw), line))
        elif kind == "ident":
            toks.append(_Tok("ident", raw, line))
        elif kind == "punct":
            toks.append(_Tok(raw, raw, line))
        pos = m.end()
    toks.append(_Tok("eof", None, line))
    return toks


# ----------------------------------------------------------------- parser
@dataclass
class Body:
    attrs: Dict[str, Any] = field(default_factory=dict)
    blocks: List[Tuple[str, List[str], "Body"]] = field(default_factory=list)

    def blocks_named(self, name: str) -> List[Tuple[List[str], "Body"]]:
        return [(labels, body) for n, labels, body in self.blocks
                if n == name]

    def one_block(self, name: str) -> Optional["Body"]:
        found = self.blocks_named(name)
        return found[0][1] if found else None

    def keys(self):
        return set(self.attrs) | {n for n, _, _ in self.blocks}


class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def expect(self, kind: str) -> _Tok:
        tok = self.next()
        if tok.kind != kind:
            raise HCLParseError(
                f"expected {kind}, got {tok.kind} ({tok.value!r})", tok.line)
        return tok

    def parse_body(self, until: str) -> Body:
        body = Body()
        while True:
            tok = self.peek()
            if tok.kind == until:
                self.next()
                return body
            if tok.kind not in ("ident", "string"):
                raise HCLParseError(
                    f"expected identifier, got {tok.kind} ({tok.value!r})",
                    tok.line)
            name = self.next().value
            tok = self.peek()
            if tok.kind == "=":
                self.next()
                if name in body.attrs:
                    raise HCLParseError(f"duplicate key {name!r}", tok.line)
                body.attrs[name] = self.parse_value()
                continue
            # block: zero or more labels then '{'
            labels: List[str] = []
            while self.peek().kind in ("string", "ident"):
                labels.append(self.next().value)
            open_tok = self.expect("{")
            body.blocks.append((name, labels, self.parse_body("}")))

    def parse_value(self) -> Any:
        tok = self.next()
        if tok.kind in ("string", "number"):
            return tok.value
        if tok.kind == "ident":
            if tok.value == "true":
                return True
            if tok.value == "false":
                return False
            raise HCLParseError(f"unexpected identifier {tok.value!r} "
                                "as value", tok.line)
        if tok.kind == "[":
            items = []
            while True:
                if self.peek().kind == "]":
                    self.next()
                    return items
                items.append(self.parse_value())
                if self.peek().kind == ",":
                    self.next()
        if tok.kind == "{":
            obj: Dict[str, Any] = {}
            while True:
                t = self.peek()
                if t.kind == "}":
                    self.next()
                    return obj
                if t.kind not in ("ident", "string"):
                    raise HCLParseError(
                        f"expected key, got {t.kind}", t.line)
                key = self.next().value
                self.expect("=")
                obj[key] = self.parse_value()
                if self.peek().kind == ",":
                    self.next()
        raise HCLParseError(f"unexpected token {tok.kind}", tok.line)


def parse_hcl(text: str) -> Body:
    return _Parser(_lex(text)).parse_body("eof")
