# Copied from gatekeeper_tpu/rego/builtins.py; only imports and the edits noted in this header differ.
# Edit: source paths in comments point into the upstream Gatekeeper repo (gatekeeper/...).
# Edit: external_data raises NotImplementedError (no provider plane here).
"""Builtin functions for the Rego interpreter.

Covers the builtin surface exercised by the reference's policy library
(gatekeeper/library) and target/hook Rego. Semantics follow the vendored
OPA topdown builtins (gatekeeper/vendor/github.com/open-policy-agent/
opa/topdown/). A builtin error (e.g. to_number on garbage) makes the calling
expression undefined, matching OPA's default (non-strict) behavior.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Tuple

from .values import freeze, opa_repr, rego_cmp, sort_key, type_name


class BuiltinError(Exception):
    """Raised by builtins on type/domain errors -> expression undefined."""


def _want(v: Any, *types: str) -> Any:
    if type_name(v) not in types:
        raise BuiltinError(f"expected {'/'.join(types)}, got {type_name(v)}")
    return v


def _count(x):
    _want(x, "array", "set", "object", "string")
    return len(x)


def _sprintf(fmt, args):
    _want(fmt, "string")
    _want(args, "array")
    out = []
    i = 0
    ai = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            if spec == "%":
                out.append("%")
                i += 2
                continue
            if spec in "vdsf":
                if ai >= len(args):
                    raise BuiltinError("sprintf: not enough args")
                arg = args[ai]
                ai += 1
                if spec == "v":
                    out.append(opa_repr(arg, top=True))
                elif spec == "d":
                    _want(arg, "number")
                    out.append(str(int(arg)))
                elif spec == "s":
                    out.append(arg if isinstance(arg, str) else opa_repr(arg, top=True))
                elif spec == "f":
                    _want(arg, "number")
                    out.append(f"{float(arg):f}")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _startswith(s, prefix):
    _want(s, "string")
    _want(prefix, "string")
    return s.startswith(prefix)


def _endswith(s, suffix):
    _want(s, "string")
    _want(suffix, "string")
    return s.endswith(suffix)


def _contains(s, sub):
    _want(s, "string")
    _want(sub, "string")
    return sub in s


def _split(s, sep):
    _want(s, "string")
    _want(sep, "string")
    return tuple(s.split(sep))


def _concat(sep, coll):
    _want(sep, "string")
    _want(coll, "array", "set")
    items = list(coll) if isinstance(coll, tuple) else sorted(coll, key=sort_key)
    for x in items:
        _want(x, "string")
    return sep.join(items)


def _trim(s, cutset):
    _want(s, "string")
    _want(cutset, "string")
    return s.strip(cutset)


def _trim_left(s, cutset):
    _want(s, "string")
    _want(cutset, "string")
    return s.lstrip(cutset)


def _trim_right(s, cutset):
    _want(s, "string")
    _want(cutset, "string")
    return s.rstrip(cutset)


def _trim_space(s):
    _want(s, "string")
    return s.strip()


def _trim_prefix(s, prefix):
    _want(s, "string")
    _want(prefix, "string")
    return s[len(prefix) :] if s.startswith(prefix) else s


def _trim_suffix(s, suffix):
    _want(s, "string")
    _want(suffix, "string")
    return s[: len(s) - len(suffix)] if suffix and s.endswith(suffix) else s


def _replace(s, old, new):
    _want(s, "string")
    _want(old, "string")
    _want(new, "string")
    return s.replace(old, new)


def _lower(s):
    _want(s, "string")
    return s.lower()


def _upper(s):
    _want(s, "string")
    return s.upper()


def _format_int(n, base):
    _want(n, "number")
    _want(base, "number")
    base = int(base)
    n = int(n)
    if base == 10:
        return str(n)
    if base == 16:
        return format(n, "x")
    if base == 8:
        return format(n, "o")
    if base == 2:
        return format(n, "b")
    raise BuiltinError("format_int: unsupported base")


_RE_CACHE: Dict[str, "re.Pattern[str]"] = {}


def compile_go_regex(pattern: str) -> "re.Pattern[str]":
    """Compile a (RE2-flavored) pattern with Python's re.

    The reference's library uses a conservative regex subset that is common to
    RE2 and Python re. Patterns that fail to compile raise BuiltinError, which
    makes the calling expression undefined (OPA errors there too).
    """
    pat = _RE_CACHE.get(pattern)
    if pat is None:
        try:
            pat = re.compile(pattern)
        except re.error as e:
            raise BuiltinError(f"re_match: bad pattern {pattern!r}: {e}")
        _RE_CACHE[pattern] = pat
    return pat


def _re_match(pattern, value):
    _want(pattern, "string")
    _want(value, "string")
    return compile_go_regex(pattern).search(value) is not None


def _to_number(x):
    t = type_name(x)
    if t == "null":
        return 0
    if t == "boolean":
        return 1 if x else 0
    if t == "number":
        return x
    if t == "string":
        s = x.strip()
        try:
            if re.fullmatch(r"[-+]?\d+", s):
                return int(s)
            return float(s)
        except ValueError:
            raise BuiltinError(f"to_number: cannot parse {x!r}")
    raise BuiltinError(f"to_number: bad type {t}")


def _any(coll):
    _want(coll, "array", "set")
    return any(x is True for x in coll)


def _all(coll):
    _want(coll, "array", "set")
    return all(x is True for x in coll)


def _sort(coll):
    _want(coll, "array", "set")
    return tuple(sorted(coll, key=sort_key))


def _sum(coll):
    _want(coll, "array", "set")
    total = 0
    for x in coll:
        _want(x, "number")
        total += x
    return total


def _max(coll):
    _want(coll, "array", "set")
    if not coll:
        raise BuiltinError("max: empty collection")
    items = sorted(coll, key=sort_key)
    return items[-1]


def _min(coll):
    _want(coll, "array", "set")
    if not coll:
        raise BuiltinError("min: empty collection")
    items = sorted(coll, key=sort_key)
    return items[0]


def _abs(n):
    _want(n, "number")
    return abs(n)


def _round(n):
    _want(n, "number")
    import math

    return math.floor(n + 0.5)


def _object_get(obj, key, default):
    _want(obj, "object")
    return obj[key] if key in obj else default


def _substring(s, start, length):
    _want(s, "string")
    _want(start, "number")
    _want(length, "number")
    start = int(start)
    length = int(length)
    if start < 0:
        raise BuiltinError("substring: negative offset")
    if length < 0:
        return s[start:]
    return s[start : start + length]


def _object_union(a, b):
    # mergeWithOverwrite semantics: recursive merge, right side wins on
    # conflicts unless both values are objects (then merged recursively);
    # mirrors gatekeeper/vendor/.../opa/topdown/object.go
    _want(a, "object")
    _want(b, "object")
    from .values import Obj

    out = dict(a)
    for k, v in b.items():
        if k in out and type_name(out[k]) == "object" and type_name(v) == "object":
            out[k] = _object_union(out[k], v)
        else:
            out[k] = v
    return Obj(out)


def _object_remove(obj, keys):
    _want(obj, "object")
    _want(keys, "array", "set", "object")
    drop = set(keys) if not isinstance(keys, dict) else set(keys.keys())
    from .values import Obj

    return Obj({k: v for k, v in obj.items() if k not in drop})


def _object_filter(obj, keys):
    _want(obj, "object")
    _want(keys, "array", "set", "object")
    keep = set(keys) if not isinstance(keys, dict) else set(keys.keys())
    from .values import Obj

    return Obj({k: v for k, v in obj.items() if k in keep})


def _trace(note):
    _want(note, "string")
    return True


def _array_concat(a, b):
    _want(a, "array")
    _want(b, "array")
    return a + b


def _to_set(coll):
    _want(coll, "array", "set")
    return frozenset(coll)


def _intersection(sets):
    _want(sets, "set")
    result = None
    for s in sets:
        _want(s, "set")
        result = s if result is None else result & s
    return result if result is not None else frozenset()


def _union(sets):
    _want(sets, "set")
    result = frozenset()
    for s in sets:
        _want(s, "set")
        result = result | s
    return result


def _json_marshal(v):
    import json

    from .values import thaw

    return json.dumps(thaw(v), separators=(",", ":"), sort_keys=True)


def _json_unmarshal(s):
    import json

    _want(s, "string")
    try:
        return freeze(json.loads(s))
    except ValueError as e:
        raise BuiltinError(f"json.unmarshal: {e}")


def _is_type(t: str) -> Callable[[Any], bool]:
    def check(v):
        return type_name(v) == t

    return check


def _external_data(req):
    """Gatekeeper v3's external_data builtin. The provider plane is not
    part of this package yet, so a template that calls it fails loudly
    instead of evaluating as if no provider answered."""
    raise NotImplementedError(
        "external_data is not supported by gatekeeper_tpu_torch"
    )


def _glob_match(pattern, delimiters, match):
    # glob.match with "*" wildcards per delimiter segment; the reference
    # snapshot's library does not use it, provided for API completeness.
    _want(pattern, "string")
    _want(match, "string")
    delims = [x for x in (delimiters or ())] if delimiters is not None else ["."]
    delim = delims[0] if delims else "."
    regex = "^" + "$DSTAR$".join(re.escape(p) for p in pattern.split("**"))
    regex = regex.replace(re.escape("*"), f"[^{re.escape(delim)}]*")
    regex = regex.replace("$DSTAR$", ".*") + "$"
    return re.match(regex, match) is not None


BUILTINS: Dict[str, Tuple[int, Callable]] = {
    "count": (1, _count),
    "sprintf": (2, _sprintf),
    "startswith": (2, _startswith),
    "endswith": (2, _endswith),
    "contains": (2, _contains),
    "split": (2, _split),
    "concat": (2, _concat),
    "trim": (2, _trim),
    "trim_left": (2, _trim_left),
    "trim_right": (2, _trim_right),
    "trim_prefix": (2, _trim_prefix),
    "trim_suffix": (2, _trim_suffix),
    "trim_space": (1, _trim_space),
    "replace": (3, _replace),
    "lower": (1, _lower),
    "upper": (1, _upper),
    "format_int": (2, _format_int),
    "re_match": (2, _re_match),
    "regex.match": (2, _re_match),
    "to_number": (1, _to_number),
    "any": (1, _any),
    "all": (1, _all),
    "sort": (1, _sort),
    "sum": (1, _sum),
    "max": (1, _max),
    "min": (1, _min),
    "abs": (1, _abs),
    "round": (1, _round),
    "object.get": (3, _object_get),
    "object.union": (2, _object_union),
    "object.remove": (2, _object_remove),
    "object.filter": (2, _object_filter),
    "substring": (3, _substring),
    "trace": (1, _trace),
    "array.concat": (2, _array_concat),
    "cast_set": (1, _to_set),
    "intersection": (1, _intersection),
    "union": (1, _union),
    "json.marshal": (1, _json_marshal),
    "json.unmarshal": (1, _json_unmarshal),
    "is_number": (1, _is_type("number")),
    "is_string": (1, _is_type("string")),
    "is_array": (1, _is_type("array")),
    "is_object": (1, _is_type("object")),
    "is_boolean": (1, _is_type("boolean")),
    "is_null": (1, _is_type("null")),
    "is_set": (1, _is_type("set")),
    "glob.match": (3, _glob_match),
    "external_data": (1, _external_data),
    # equality / comparison exposed as functions (used via operators mostly)
    "eq": (2, lambda a, b: rego_cmp(a, b) == 0),
    "neq": (2, lambda a, b: rego_cmp(a, b) != 0),
}
