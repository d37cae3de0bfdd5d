# Copied from gatekeeper_tpu/rego/values.py; only imports and the edits noted in this header differ.
# Edit: source paths in comments point into the upstream Gatekeeper repo (gatekeeper/...).
"""Canonical immutable value model for the Rego interpreter.

Values are kept in frozen form throughout evaluation so sets/object-keys and
unification are well-defined:

  null     -> None
  boolean  -> bool
  number   -> int | float       (ints and floats compare equal, as in Rego)
  string   -> str
  array    -> tuple
  object   -> Obj (immutable, hashable mapping)
  set      -> frozenset

Known limitation (documented): Python treats True == 1, so a set containing
both `true` and `1` would collapse; this combination does not occur in the
reference's policy corpus (gatekeeper/library).

Ordering follows OPA's total term order (null < bool < number < string <
array < object < set; see the vendored OPA's ast term Compare semantics at
gatekeeper/vendor/github.com/open-policy-agent/opa/ast/term.go) so that
sort()/set-iteration/printing are deterministic and reference-shaped.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Tuple


class Obj(Mapping):
    """Immutable hashable object (Rego object value)."""

    __slots__ = ("_d", "_hash")

    def __init__(self, d: Mapping):
        self._d = dict(d)
        self._hash = None

    def __getitem__(self, k):
        return self._d[k]

    def __iter__(self) -> Iterator:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __hash__(self):
        if self._hash is None:
            self._hash = hash(frozenset(self._d.items()))
        return self._hash

    def __eq__(self, other):
        if isinstance(other, Obj):
            return self._d == other._d
        if isinstance(other, Mapping):
            return self._d == dict(other)
        return NotImplemented

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Obj({self._d!r})"

    def set(self, k, v) -> "Obj":
        d = dict(self._d)
        d[k] = v
        return Obj(d)


EMPTY_OBJ = Obj({})


def freeze(v: Any) -> Any:
    """JSON-ish Python value -> frozen canonical value."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, Obj):
        # Obj is only ever built over frozen contents — re-freezing a
        # cached subtree (e.g. the audit inventory) must be O(1)
        return v
    if isinstance(v, (list, tuple)):
        return tuple(freeze(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return frozenset(freeze(x) for x in v)
    if isinstance(v, Mapping):
        return Obj({freeze(k): freeze(val) for k, val in v.items()})
    raise TypeError(f"cannot freeze value of type {type(v)}")


def thaw(v: Any) -> Any:
    """Frozen value -> plain JSON-ish Python value (sets become sorted lists)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, tuple):
        return [thaw(x) for x in v]
    if isinstance(v, frozenset):
        return [thaw(x) for x in sorted(v, key=sort_key)]
    if isinstance(v, Obj):
        return {thaw(k): thaw(val) for k, val in v.items()}
    raise TypeError(f"cannot thaw value of type {type(v)}")


def type_name(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, tuple):
        return "array"
    if isinstance(v, Obj):
        return "object"
    if isinstance(v, frozenset):
        return "set"
    raise TypeError(f"unknown value type {type(v)}")


_TYPE_RANK = {
    "null": 0,
    "boolean": 1,
    "number": 2,
    "string": 3,
    "array": 4,
    "object": 5,
    "set": 6,
}


def rego_cmp(a: Any, b: Any) -> int:
    """Total order over values, mirroring OPA term comparison."""
    ta, tb = type_name(a), type_name(b)
    if ta != tb:
        return -1 if _TYPE_RANK[ta] < _TYPE_RANK[tb] else 1
    if ta == "null":
        return 0
    if ta == "boolean":
        return (a > b) - (a < b)
    if ta == "number":
        return (a > b) - (a < b)
    if ta == "string":
        return (a > b) - (a < b)
    if ta == "array":
        for x, y in zip(a, b):
            c = rego_cmp(x, y)
            if c:
                return c
        return (len(a) > len(b)) - (len(a) < len(b))
    if ta == "object":
        ka = sorted(a.keys(), key=sort_key)
        kb = sorted(b.keys(), key=sort_key)
        for x, y in zip(ka, kb):
            c = rego_cmp(x, y)
            if c:
                return c
            c = rego_cmp(a[x], b[y])
            if c:
                return c
        return (len(ka) > len(kb)) - (len(ka) < len(kb))
    if ta == "set":
        sa = sorted(a, key=sort_key)
        sb = sorted(b, key=sort_key)
        for x, y in zip(sa, sb):
            c = rego_cmp(x, y)
            if c:
                return c
        return (len(sa) > len(sb)) - (len(sa) < len(sb))
    raise TypeError(ta)


class _SortKey:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return rego_cmp(self.v, other.v) < 0

    def __eq__(self, other):
        return rego_cmp(self.v, other.v) == 0


def sort_key(v: Any) -> _SortKey:
    return _SortKey(v)


def rego_eq(a: Any, b: Any) -> bool:
    """Type-strict equality (booleans are never equal to numbers)."""
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return rego_cmp(a, b) == 0 if type_name(a) == type_name(b) else False


def _num_str(n) -> str:
    if isinstance(n, bool):  # pragma: no cover - callers dispatch on type
        return "true" if n else "false"
    if isinstance(n, int):
        return str(n)
    if n == int(n) and abs(n) < 1e15:
        return str(int(n))
    return repr(n)


def opa_repr(v: Any, top: bool = False) -> str:
    """Render a value the way OPA's sprintf(%v) does.

    Top-level strings print raw; nested strings print JSON-quoted. Sets print
    as {...} in sorted term order; objects sort keys. This matches the message
    text Gatekeeper produces for e.g.
    'you must provide labels: {"gatekeeper"}'
    (gatekeeper/library/general/requiredlabels/template.yaml).
    """
    t = type_name(v)
    if t == "null":
        return "null"
    if t == "boolean":
        return "true" if v else "false"
    if t == "number":
        return _num_str(v)
    if t == "string":
        if top:
            return v
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if t == "array":
        return "[" + ", ".join(opa_repr(x) for x in v) + "]"
    if t == "set":
        if not v:
            return "set()"
        return "{" + ", ".join(opa_repr(x) for x in sorted(v, key=sort_key)) + "}"
    if t == "object":
        items = sorted(v.items(), key=lambda kv: sort_key(kv[0]))
        return "{" + ", ".join(f"{opa_repr(k)}: {opa_repr(x)}" for k, x in items) + "}"
    raise TypeError(t)


def is_truthy(v: Any) -> bool:
    """Rego expression satisfaction: everything but `false` is satisfied."""
    return v is not False
