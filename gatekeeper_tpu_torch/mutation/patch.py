# Copied from gatekeeper_tpu/mutation/patch.py; unchanged.
"""RFC 6902 JSONPatch rendering: before/after object diff.

The `/v1/mutate` webhook answers with a patch, not the mutated object
(the apiserver applies the patch itself), so the mutation engine's
output must be rendered as add/replace/remove operations. The diff is
structural and minimal-ish: dicts recurse per key, lists recurse per
index when same-length, extend with `add` ops when the original is a
prefix, truncate with end-first `remove` ops when the result is a
prefix, and fall back to a whole-list `replace` otherwise (apiserver
JSONPatch application is positional, so index-precise ops matter more
than op-count minimality).
"""

from __future__ import annotations

from typing import Any, Dict, List


def escape_pointer(seg: str) -> str:
    """RFC 6901 token escaping."""
    return str(seg).replace("~", "~0").replace("/", "~1")


def json_patch(before: Any, after: Any) -> List[Dict[str, Any]]:
    """RFC 6902 ops transforming `before` into `after` (empty when
    equal). Ops are emitted in application order — removes within one
    list come highest-index-first so earlier ops don't shift the
    indices later ones target."""
    ops: List[Dict[str, Any]] = []
    _diff(before, after, "", ops)
    return ops


def _diff(before: Any, after: Any, path: str, ops: List[Dict[str, Any]]):
    if before == after and type(before) is type(after):
        return
    if isinstance(before, dict) and isinstance(after, dict):
        for k in before:
            if k not in after:
                ops.append(
                    {"op": "remove", "path": f"{path}/{escape_pointer(k)}"}
                )
        for k, v in after.items():
            sub = f"{path}/{escape_pointer(k)}"
            if k not in before:
                ops.append({"op": "add", "path": sub, "value": v})
            else:
                _diff(before[k], v, sub, ops)
        return
    if isinstance(before, list) and isinstance(after, list):
        nb, na = len(before), len(after)
        if na >= nb and before == after[:nb]:
            for i in range(nb, na):
                ops.append(
                    {"op": "add", "path": f"{path}/{i}", "value": after[i]}
                )
            return
        if nb > na and after == before[:na]:
            for i in range(nb - 1, na - 1, -1):
                ops.append({"op": "remove", "path": f"{path}/{i}"})
            return
        if nb == na:
            for i in range(nb):
                _diff(before[i], after[i], f"{path}/{i}", ops)
            return
        ops.append({"op": "replace", "path": path, "value": after})
        return
    ops.append({"op": "replace", "path": path, "value": after})


def apply_patch(obj: Any, ops: List[Dict[str, Any]]) -> Any:
    """Minimal RFC 6902 applier (add/replace/remove) — used by tests
    and the offline lint to verify rendered patches round-trip; NOT a
    full implementation (no move/copy/test)."""
    import copy as _copy
    import json as _json

    out = _copy.deepcopy(obj)
    for op in ops:
        path = op["path"]
        if path == "":
            out = _copy.deepcopy(op["value"])
            continue
        segs = [
            s.replace("~1", "/").replace("~0", "~")
            for s in path.split("/")[1:]
        ]
        parent = out
        for s in segs[:-1]:
            parent = parent[int(s)] if isinstance(parent, list) else parent[s]
        last = segs[-1]
        kind = op["op"]
        if isinstance(parent, list):
            idx = len(parent) if last == "-" else int(last)
            if kind == "add":
                parent.insert(idx, _copy.deepcopy(op["value"]))
            elif kind == "replace":
                parent[idx] = _copy.deepcopy(op["value"])
            elif kind == "remove":
                del parent[idx]
            else:
                raise ValueError(f"unsupported op {kind!r}")
        else:
            if kind == "add" or kind == "replace":
                parent[last] = _copy.deepcopy(op["value"])
            elif kind == "remove":
                del parent[last]
            else:
                raise ValueError(f"unsupported op {kind!r}")
    # normalize away any shared references
    return _json.loads(_json.dumps(out))
