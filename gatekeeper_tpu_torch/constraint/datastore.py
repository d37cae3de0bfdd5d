# Copied from gatekeeper_tpu/constraint/datastore.py; only imports and the edits noted in this header differ.
"""In-memory hierarchical data store for driver base documents.

The CPU equivalent of the reference driver's OPA inmem storage usage
(vendor/.../frameworks/constraint/pkg/client/drivers/local/local.go:241-300):
slash-separated paths, parent auto-creation on write, and conflict errors
when a write descends through a non-object (local.go:248-273 checks path
conflicts via storage.MakeDir semantics).
"""

from __future__ import annotations

import copy
import json
from typing import Any, List, Optional, Tuple, Union

PathLike = Union[str, List[str]]


class PathConflictError(Exception):
    """Write path traverses an existing non-object value."""


_HEX = set("0123456789abcdefABCDEF")


def _path_unescape(seg: str) -> str:
    """Go url.PathUnescape: %XX decoded ("+" untouched); any malformed
    escape errors, in which case ParsePathEscaped keeps the segment as-is
    (opa/storage/path.go:35-46)."""
    if "%" not in seg:
        return seg
    i = seg.find("%")
    while i != -1:
        if len(seg) - i < 3 or seg[i + 1] not in _HEX or seg[i + 2] not in _HEX:
            return seg  # malformed escape: keep original
        i = seg.find("%", i + 3)
    from urllib.parse import unquote

    return unquote(seg)


def parse_path(path: PathLike) -> List[str]:
    """storage.ParsePathEscaped (local.go:233-239): split on "/", then
    URL-unescape each segment — data keys hold the unescaped form (e.g.
    groupVersion "extensions/v1beta1"), the escaping exists only in the
    path-string transport."""
    if isinstance(path, str):
        return [_path_unescape(seg) for seg in path.split("/") if seg != ""]
    return list(path)


class DataStore:
    """A dict tree addressed by /seg/seg/... paths."""

    def __init__(self):
        self._root: dict = {}

    def put(self, path: PathLike, value: Any) -> None:
        segs = parse_path(path)
        if not segs:
            if not isinstance(value, dict):
                raise PathConflictError("root document must be an object")
            self._root = copy.deepcopy(value)
            return
        node = self._root
        for seg in segs[:-1]:
            if seg not in node:
                node[seg] = {}
            child = node[seg]
            if not isinstance(child, dict):
                # stored None leaves conflict too — absence is keyed on the
                # dict, not the value
                raise PathConflictError(
                    f"path segment {seg!r} is a leaf, cannot descend"
                )
            node = child
        node[segs[-1]] = copy.deepcopy(value)

    def delete(self, path: PathLike) -> bool:
        """Remove the subtree at path. Returns False if it did not exist."""
        segs = parse_path(path)
        if not segs:
            existed = bool(self._root)
            self._root = {}
            return existed
        node = self._root
        for seg in segs[:-1]:
            child = node.get(seg)
            if not isinstance(child, dict):
                return False
            node = child
        if segs[-1] not in node:
            return False
        del node[segs[-1]]
        return True

    def get(self, path: PathLike, default: Any = None) -> Any:
        node: Any = self._root
        for seg in parse_path(path):
            if not isinstance(node, dict) or seg not in node:
                return default
            node = node[seg]
        return node

    def snapshot(self, path: PathLike = "") -> Any:
        return copy.deepcopy(self.get(path, {}))

    def dump_json(self) -> str:
        return json.dumps(self._root, sort_keys=True, indent=2, default=str)
