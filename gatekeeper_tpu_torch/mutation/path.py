# Copied from gatekeeper_tpu/mutation/path.py; unchanged.
"""Location-path grammar for mutators.

Gatekeeper's mutation location syntax (pkg/mutation/path/parser):

    spec.template.spec.containers[name: *].image
    spec.containers[name: "sidecar"].securityContext
    metadata.labels."my.dotted/key"

  * `.`-separated object segments; a segment may be double-quoted to
    carry dots, brackets, or spaces literally;
  * `[key: value]` addresses a LIST whose elements are objects keyed by
    `key`; `value` may be `*` (glob: every element with the key field),
    a bare token, or a double-quoted string;
  * the key field and value tolerate surrounding whitespace.

Parsed form: a tuple of nodes — `ObjectNode(name)` for field access,
`ListNode(name, key_field, key_value, glob)` for keyed list access.
The node types double as the schema the conflict detector compares:
a `ListNode` asserts its field is a list; an `ObjectNode` that is not
the final node asserts its field is an object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union


class PathError(ValueError):
    """Malformed location path (position-annotated message)."""


@dataclass(frozen=True)
class ObjectNode:
    name: str


@dataclass(frozen=True)
class ListNode:
    name: str
    key_field: str
    key_value: Optional[str]  # None when glob
    glob: bool


Node = Union[ObjectNode, ListNode]


def _err(path: str, pos: int, why: str) -> PathError:
    return PathError(f"invalid location {path!r} at offset {pos}: {why}")


def _read_token(path: str, i: int, stop: str) -> Tuple[str, int]:
    """Read a quoted string or a bare token ending at any char in
    `stop` (exclusive). Returns (text, next index)."""
    if i < len(path) and path[i] == '"':
        j = i + 1
        out = []
        while j < len(path):
            c = path[j]
            if c == "\\" and j + 1 < len(path):
                out.append(path[j + 1])
                j += 2
                continue
            if c == '"':
                return "".join(out), j + 1
            out.append(c)
            j += 1
        raise _err(path, i, "unterminated quote")
    j = i
    while j < len(path) and path[j] not in stop:
        j += 1
    return path[i:j], j


def parse_path(path: str) -> Tuple[Node, ...]:
    """Parse a location string into its node tuple (raises PathError)."""
    if not isinstance(path, str) or not path.strip():
        raise PathError(f"invalid location {path!r}: empty path")
    path = path.strip()
    nodes: List[Node] = []
    i = 0
    while i < len(path):
        name, i = _read_token(path, i, ".[")
        name = name.strip()
        if not name:
            raise _err(path, i, "empty segment")
        if i < len(path) and path[i] == "[":
            j = path.find("]", i)
            if j < 0:
                raise _err(path, i, "unterminated '['")
            inner = path[i + 1 : j]
            key, k = _read_token(inner, 0, ":")
            if k >= len(inner) or inner[k] != ":":
                raise _err(path, i, "list accessor needs 'key: value'")
            key = key.strip()
            if not key:
                raise _err(path, i, "empty key field")
            value_raw = inner[k + 1 :].strip()
            if value_raw == "*":
                nodes.append(ListNode(name, key, None, glob=True))
            else:
                value, _ = _read_token(value_raw, 0, "")
                value = value if value_raw.startswith('"') else value.strip()
                if not value:
                    raise _err(path, i, "empty key value")
                nodes.append(ListNode(name, key, value, glob=False))
            i = j + 1
        else:
            nodes.append(ObjectNode(name))
        if i < len(path):
            if path[i] != ".":
                raise _err(path, i, f"expected '.' before {path[i]!r}")
            i += 1
            if i >= len(path):
                raise _err(path, i, "trailing '.'")
    if not nodes:
        raise PathError(f"invalid location {path!r}: empty path")
    return tuple(nodes)


def _quote_seg(s: str) -> str:
    if s and all(c not in '."[]: \\' for c in s):
        return s
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def render_path(nodes: Tuple[Node, ...]) -> str:
    """Canonical string form of a parsed path (parse ∘ render = id)."""
    out = []
    for n in nodes:
        if isinstance(n, ListNode):
            val = "*" if n.glob else _quote_seg(n.key_value)
            out.append(f"{_quote_seg(n.name)}[{_quote_seg(n.key_field)}: {val}]")
        else:
            out.append(_quote_seg(n.name))
    return ".".join(out)
