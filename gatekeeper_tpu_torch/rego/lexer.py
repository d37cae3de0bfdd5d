# Copied from gatekeeper_tpu/rego/lexer.py; only imports and the edits noted in this header differ.
# Edit: source paths in comments point into the upstream Gatekeeper repo (gatekeeper/...).
"""Rego lexer.

Token stream for the parser. Mirrors the surface syntax accepted by the
vendored OPA scanner (gatekeeper/vendor/github.com/open-policy-agent/
opa/ast/parser.go) for the dialect used in Gatekeeper's library.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional


class LexError(Exception):
    def __init__(self, msg: str, line: int):
        super().__init__(f"line {line}: {msg}")
        self.line = line


@dataclass
class Token:
    kind: str  # ident, string, rawstring, number, punct, keyword, eof
    value: Any
    line: int

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Token({self.kind}, {self.value!r}, L{self.line})"


KEYWORDS = {
    "package",
    "import",
    "default",
    "not",
    "with",
    "as",
    "some",
    "in",
    "every",
    "else",
    "true",
    "false",
    "null",
}

# Multi-char puncts first (longest match wins).
PUNCTS = [
    ":=",
    "==",
    "!=",
    "<=",
    ">=",
    "{",
    "}",
    "[",
    "]",
    "(",
    ")",
    ",",
    ";",
    ":",
    ".",
    "|",
    "&",
    "+",
    "-",
    "*",
    "/",
    "%",
    "<",
    ">",
    "=",
]


class Lexer:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0
        self.line = 1
        self.tokens: List[Token] = []

    def error(self, msg: str) -> LexError:
        return LexError(msg, self.line)

    def peek(self, off: int = 0) -> str:
        p = self.pos + off
        return self.src[p] if p < len(self.src) else ""

    def tokenize(self) -> List[Token]:
        while self.pos < len(self.src):
            c = self.src[self.pos]
            if c == "\n":
                # newlines are significant separators between body exprs
                self._emit("newline", "\n")
                self.pos += 1
                self.line += 1
            elif c in " \t\r":
                self.pos += 1
            elif c == "#":
                while self.pos < len(self.src) and self.src[self.pos] != "\n":
                    self.pos += 1
            elif c == '"':
                self._string()
            elif c == "`":
                self._raw_string()
            elif c.isdigit() or (
                c == "." and self.peek(1).isdigit()
            ):
                self._number()
            elif c.isalpha() or c == "_":
                self._ident()
            else:
                self._punct()
        self._emit("eof", None)
        return self.tokens

    def _emit(self, kind: str, value: Any) -> None:
        # collapse runs of newlines
        if kind == "newline" and self.tokens and self.tokens[-1].kind == "newline":
            return
        self.tokens.append(Token(kind, value, self.line))

    def _string(self) -> None:
        start_line = self.line
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.src):
                raise LexError("unterminated string", start_line)
            c = self.src[self.pos]
            if c == '"':
                self.pos += 1
                break
            if c == "\n":
                raise LexError("newline in string", start_line)
            if c == "\\":
                self.pos += 1
                e = self.peek()
                self.pos += 1
                if e == "n":
                    out.append("\n")
                elif e == "t":
                    out.append("\t")
                elif e == "r":
                    out.append("\r")
                elif e == '"':
                    out.append('"')
                elif e == "\\":
                    out.append("\\")
                elif e == "/":
                    out.append("/")
                elif e == "u":
                    hexs = self.src[self.pos : self.pos + 4]
                    try:
                        out.append(chr(int(hexs, 16)))
                    except ValueError:
                        raise LexError("bad unicode escape", start_line)
                    if len(hexs) != 4:
                        raise LexError("bad unicode escape", start_line)
                    self.pos += 4
                else:
                    raise LexError(f"bad escape \\{e}", start_line)
            else:
                out.append(c)
                self.pos += 1
        self.tokens.append(Token("string", "".join(out), start_line))

    def _raw_string(self) -> None:
        start_line = self.line
        self.pos += 1
        end = self.src.find("`", self.pos)
        if end < 0:
            raise LexError("unterminated raw string", start_line)
        text = self.src[self.pos : end]
        self.line += text.count("\n")
        self.pos = end + 1
        self.tokens.append(Token("string", text, start_line))

    def _number(self) -> None:
        start = self.pos
        while self.peek().isdigit():
            self.pos += 1
        is_float = False
        if self.peek() == "." and self.peek(1).isdigit():
            is_float = True
            self.pos += 1
            while self.peek().isdigit():
                self.pos += 1
        if self.peek() in "eE":
            nxt = self.peek(1)
            if nxt.isdigit() or (nxt in "+-" and self.peek(2).isdigit()):
                is_float = True
                self.pos += 1
                if self.peek() in "+-":
                    self.pos += 1
                while self.peek().isdigit():
                    self.pos += 1
        text = self.src[start : self.pos]
        self.tokens.append(
            Token("number", float(text) if is_float else int(text), self.line)
        )

    def _ident(self) -> None:
        start = self.pos
        while self.peek().isalnum() or self.peek() == "_":
            self.pos += 1
        name = self.src[start : self.pos]
        if name in KEYWORDS:
            self.tokens.append(Token("keyword", name, self.line))
        else:
            self.tokens.append(Token("ident", name, self.line))

    def _punct(self) -> None:
        for p in PUNCTS:
            if self.src.startswith(p, self.pos):
                self.tokens.append(Token("punct", p, self.line))
                self.pos += len(p)
                return
        raise self.error(f"unexpected character {self.src[self.pos]!r}")


def tokenize(src: str) -> List[Token]:
    return Lexer(src).tokenize()
