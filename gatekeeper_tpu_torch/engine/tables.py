# Copied from gatekeeper_tpu/engine/tables.py; only imports and the edits noted in this header differ.
"""Vocab-derived string tables: per-distinct-string predicate/transform caches.

The device never touches strings. Any string computation a template needs —
regex checks, prefix/suffix tests, quantity canonicalization, arbitrary
pure string->scalar helper functions (e.g. k8scontainerlimits'
canonify_cpu) — is evaluated once per distinct vocab entry on the host and
shipped as a [vocab_size] table the kernel gathers with the token's value
id. Resource batches share vocab entries heavily, so this amortizes the
string work the reference's interpreter redoes per object per query.

Tables are registered by name with a callback `fn(raw_string) ->
(value, defined)`; sync() extends all tables as the vocab grows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..flatten.vocab import Vocab


@dataclass
class _Table:
    fn: Callable[[str], Tuple[Any, bool]]
    dtype: Any
    values: np.ndarray
    defined: np.ndarray
    # content-addressed persistence (oracle tables): entries computed by
    # the interpreter oracle memoize across processes — SURVEY §5's
    # "compiled rule tensors are a cache keyed on template hash"
    persist_key: Optional[str] = None
    persist_store: Optional[Dict[str, Tuple[Any, bool]]] = None
    persist_new: int = 0
    # transform tables (str_transform): True enables the composition-
    # depth cutoff in _fill — without it, mutually prefixing transforms
    # grow the vocab exponentially under sync()'s fixed point
    is_transform: bool = False
    # the raw str->str transform (transforms only): fill_overlay interns
    # outputs into the OVERLAY, which the table_fn closure (bound to the
    # base vocab) cannot do
    raw_xf: Optional[Callable[[str], str]] = None


class StrTables:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self._tables: Dict[str, _Table] = {}
        self.generation = 0
        # transform-composition depth per vocab id: organically interned
        # entries (corpus values, captures, params) have depth 0; a
        # transform output's depth is input+1. Transforms skip inputs at
        # depth >= XF_MAX_DEPTH, bounding the sync() fixed point while
        # still transforming every organic string AND one level of
        # cross-table composition (tabA[tabB[vid]] chains). Only strings
        # whose content coincides with a depth>=2 composed product can
        # see an undefined transform — documented corner.
        self._xf_depth: Dict[int, int] = {}
        self._fill_depth = 0  # depth of the entry currently being filled

    def register(
        self,
        name: str,
        fn: Callable[[Any], Tuple[Any, bool]],
        dtype=np.float32,
        persist_key: Optional[str] = None,
        is_transform: bool = False,
    ) -> str:
        """Idempotent by name. fn receives the decoded scalar VALUE of each
        vocab entry — a str for "s:" entries, the parsed JSON scalar
        (number/bool/null) for "j:" entries; path entries are skipped.

        `persist_key`: content hash enabling a cross-process disk
        memo of fn results (for expensive interpreter-oracle fns)."""
        if name not in self._tables:
            t = _Table(
                fn=fn,
                dtype=dtype,
                values=np.zeros((0,), dtype),
                defined=np.zeros((0,), bool),
                persist_key=persist_key,
                is_transform=is_transform,
            )
            if persist_key is not None:
                t.persist_store = _load_persist(persist_key)
            self._tables[name] = t
            self._fill(t)
            self.generation += 1
        return name

    def _fill(self, t: _Table) -> None:
        n = len(self.vocab)
        start = t.values.shape[0]
        if start >= n:
            return
        vals = np.zeros((n,), t.dtype)
        defined = np.zeros((n,), bool)
        vals[:start] = t.values
        defined[:start] = t.defined
        store = t.persist_store
        for i in range(start, n):
            if t.is_transform:
                d = self._xf_depth.get(i, 0)
                if d >= XF_MAX_DEPTH:
                    continue  # composition-depth cutoff (see __init__)
                self._fill_depth = d
            raw = self.vocab.string(i)
            val = _decode_entry(raw)
            if val is _SKIP:
                continue
            if store is not None:
                hit = store.get(raw)
                if hit is not None:
                    v, d = hit
                    if d:
                        vals[i] = v
                        defined[i] = True
                    continue
            try:
                v, d = t.fn(val)
            except Exception:
                v, d = 0, False
            if d:
                vals[i] = v
                defined[i] = True
            if store is not None:
                store[raw] = (v if d else 0, d)
                t.persist_new += 1
        t.values = vals
        t.defined = defined
        if t.persist_key is not None and t.persist_new >= 1024:
            _save_persist(t.persist_key, t.persist_store)
            t.persist_new = 0

    def sync(self) -> None:
        """Extend tables to cover the vocab; loops to a fixed point since
        id-valued transforms (lower/trim) intern NEW strings during fill."""
        changed = False
        while True:
            n = len(self.vocab)
            done = all(
                t.values.shape[0] >= n for t in self._tables.values()
            )
            if done and len(self.vocab) == n:
                break
            for t in self._tables.values():
                self._fill(t)
            changed = True
            if len(self.vocab) == n:
                break
        if changed:
            self.generation += 1
        # flush pending memo entries even when this sync had nothing to
        # extend (register()'s immediate fill may have produced them)
        for t in self._tables.values():
            if t.persist_key is not None and t.persist_new:
                _save_persist(t.persist_key, t.persist_store)
                t.persist_new = 0

    def arrays(self) -> Dict[str, np.ndarray]:
        """name -> values table, name+"!def" -> defined table."""
        out: Dict[str, np.ndarray] = {}
        for name, t in self._tables.items():
            out[name] = t.values
            out[name + "!def"] = t.defined
        return out

    def fill_overlay(
        self, overlay, start: int, end: int
    ) -> Dict[str, np.ndarray]:
        """Per-table rows for overlay entries [start, end): the ephemeral
        counterpart of _fill, never touching the base tables or vocab.
        Transform outputs intern into the OVERLAY (raw_xf); the caller
        loops while the overlay keeps growing. Depth bookkeeping mirrors
        _fill: overlay-born transform products get depth input+1 and are
        cut off at XF_MAX_DEPTH."""
        names = list(self._tables)
        cols: Dict[str, Tuple[list, list]] = {n: ([], []) for n in names}
        depth = getattr(overlay, "_ov_xf_depth", None)
        if depth is None:
            depth = overlay._ov_xf_depth = {}
        for i in range(start, end):
            raw = overlay.string(i)
            val = _decode_entry(raw)
            for n in names:
                t = self._tables[n]
                v, d = 0, False
                if val is not _SKIP:
                    if t.is_transform:
                        de = depth.get(i, 0)
                        if de < XF_MAX_DEPTH and isinstance(val, str):
                            try:
                                out_s = t.raw_xf(val)
                            except Exception:
                                out_s = None
                            if out_s is not None:
                                oid = overlay.str_id(out_s)
                                nd = de + 1
                                if nd < depth.get(oid, 99):
                                    depth[oid] = nd
                                v, d = oid, True
                    else:
                        try:
                            v, d = t.fn(val)
                        except Exception:
                            v, d = 0, False
                vals, defs = cols[n]
                vals.append(v if d else 0)
                defs.append(d)
        out: Dict[str, np.ndarray] = {}
        for n in names:
            t = self._tables[n]
            vals, defs = cols[n]
            out[n] = np.asarray(vals, t.dtype)
            out[n + "!def"] = np.asarray(defs, bool)
        return out

    # -- common predicate helpers ------------------------------------------
    # string builtins on non-string values are builtin errors in Rego
    # (-> undefined), so non-str entries stay defined=False

    def regex(self, pattern: str) -> str:
        import re as _re

        try:
            rx = _re.compile(pattern)
        except _re.error:
            rx = None

        def fn(s):
            if rx is None or not isinstance(s, str):
                return False, False
            return rx.search(s) is not None, True

        return self.register(f"re:{pattern}", fn, dtype=bool)

    def prefix(self, p: str) -> str:
        return self.register(
            f"pre:{p}",
            lambda s: (s.startswith(p), True) if isinstance(s, str) else (False, False),
            dtype=bool,
        )

    def suffix(self, p: str) -> str:
        return self.register(
            f"suf:{p}",
            lambda s: (s.endswith(p), True) if isinstance(s, str) else (False, False),
            dtype=bool,
        )

    def contains(self, p: str) -> str:
        return self.register(
            f"has:{p}",
            lambda s: (p in s, True) if isinstance(s, str) else (False, False),
            dtype=bool,
        )


    def str_transform(self, name: str, fn: Callable[[str], str]) -> str:
        """id -> id table: interned result of a pure string transform.
        Outputs carry a composition depth (input+1); _fill skips inputs
        past XF_MAX_DEPTH so the sync() fixed point converges even for
        mutually prefixing transforms."""
        vocab = self.vocab

        def table_fn(s):
            if not isinstance(s, str):
                return -1, False
            try:
                out = fn(s)
            except Exception:
                return -1, False
            oid = vocab.str_id(out)
            d = self._fill_depth + 1
            if d < self._xf_depth.get(oid, 99):
                self._xf_depth[oid] = d
            return oid, True

        key = self.register(
            f"xf:{name}", table_fn, dtype=np.int32, is_transform=True
        )
        if self._tables[key].raw_xf is None:
            self._tables[key].raw_xf = fn
        return key


_SKIP = object()

# transform-composition depth cutoff (see StrTables.__init__)
XF_MAX_DEPTH = 2


def _persist_dir() -> Optional[str]:
    import os

    if os.environ.get("GATEKEEPER_TPU_NO_COMPILE_CACHE") == "1":
        return None
    return os.environ.get(
        "GATEKEEPER_TPU_ORACLE_CACHE_DIR",
        os.path.expanduser("~/.cache/gatekeeper_tpu/oracle_tables"),
    )


def _persist_path(key: str) -> Optional[str]:
    import hashlib
    import os

    d = _persist_dir()
    if d is None:
        return None
    return os.path.join(d, hashlib.sha256(key.encode()).hexdigest() + ".npz")


def _load_persist(key: str) -> Dict[str, Tuple[Any, bool]]:
    path = _persist_path(key)
    if path is None:
        return {}
    try:
        with np.load(path, allow_pickle=False) as z:
            strings = z["strings"]
            values = z["values"]
            defined = z["defined"]
        return {
            str(s): (float(v), bool(d))
            for s, v, d in zip(strings, values, defined)
        }
    except Exception:
        return {}


def _save_persist(key: str, store: Dict[str, Tuple[Any, bool]]) -> None:
    path = _persist_path(key)
    if path is None or not store:
        return
    import os
    import tempfile

    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        strings = np.array(list(store.keys()))
        values = np.array([float(v) for v, _ in store.values()], np.float64)
        defined = np.array([d for _, d in store.values()], bool)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        os.close(fd)
        np.savez_compressed(
            tmp, strings=strings, values=values, defined=defined
        )
        # savez appends .npz to names lacking it
        os.replace(tmp + ".npz", path)
        os.unlink(tmp)
    except Exception:
        pass  # persistence is an optimization; never fail the fill


def _decode_entry(s: str):
    if s.startswith("s:"):
        return s[2:]
    if s.startswith("j:"):
        import json

        try:
            return json.loads(s[2:])
        except ValueError:
            return _SKIP
    return _SKIP
