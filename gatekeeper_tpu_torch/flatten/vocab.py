# Copied from gatekeeper_tpu/flatten/vocab.py; only imports and the edits noted in this header differ.
"""Append-only string vocabulary with intern-time precomputation.

Ids are stable (append-only), so growing the vocab never invalidates
previously encoded tensors. Value-typed interning (`val_id`) tags
non-string JSON scalars so cross-type equality can never alias.

Expensive string predicates (regex match, prefix match, k8s quantity
parsing) are evaluated once per distinct vocab entry and memoized —
the TPU analog of doing `re_match`/`startswith`/quantity parsing inside
OPA's interpreter loop per object (e.g. the reference library's
k8srequiredlabels regex check and k8scontainerlimits quantity math).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

_QUNSET = object()

# k8s resource.Quantity suffixes (apimachinery resource.ParseQuantity)
_QUANTITY_RE = re.compile(
    r"^([+-]?[0-9]+(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?)"
    r"(m|k|M|G|T|P|E|Ki|Mi|Gi|Ti|Pi|Ei)?$"
)
_SUFFIX = {
    None: 1.0,
    "m": 1e-3,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
    "Ki": 2.0**10,
    "Mi": 2.0**20,
    "Gi": 2.0**30,
    "Ti": 2.0**40,
    "Pi": 2.0**50,
    "Ei": 2.0**60,
}


def parse_quantity(s: str) -> Optional[float]:
    """Parse a k8s resource quantity ("100m", "1Gi", "2") to a float."""
    if not isinstance(s, str):
        return None
    m = _QUANTITY_RE.match(s.strip())
    if not m:
        return None
    return float(m.group(1)) * _SUFFIX[m.group(2)]


class Vocab:
    """Interned strings + per-entry predicate caches."""

    def __init__(self):
        self._ids: Dict[str, int] = {}
        self._strs: List[str] = []
        # entry-id -> parsed quantity (or None)
        self._quantity: List[Optional[float]] = []
        # regex pattern -> {entry_id: bool} lazy caches
        self._regex_cache: Dict[str, Dict[int, bool]] = {}
        self._prefix_cache: Dict[str, Dict[int, bool]] = {}
        self._vid_quantity: Dict[int, Optional[float]] = {}

    def __len__(self) -> int:
        return len(self._strs)

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._strs)
            self._ids[s] = i
            self._strs.append(s)
            self._quantity.append(parse_quantity(s))
        return i

    def lookup(self, s: str) -> int:
        """Id of s, or -1 if never interned (safe for probe-only queries)."""
        return self._ids.get(s, -1)

    def string(self, i: int) -> str:
        return self._strs[i]

    def quantity(self, i: int) -> Optional[float]:
        return self._quantity[i]

    def quantity_of_val_id(self, vid: int) -> Optional[float]:
        """Quantity parse of a typed value entry ("s:..." strings only),
        memoized per entry — avoids interning the raw string a second
        time."""
        q = self._vid_quantity.get(vid)
        if q is _QUNSET or q is None and vid not in self._vid_quantity:
            s = self.string(vid)
            q = parse_quantity(s[2:]) if s.startswith("s:") else None
            self._vid_quantity[vid] = q
        return q

    # -- typed value interning ---------------------------------------------

    def val_id(self, v: Any) -> int:
        """Intern an arbitrary JSON scalar with a type tag, so "1" != 1 and
        "true" != true under id equality. Numbers are normalized (1.0 and 1
        share an id) to match Rego numeric equality."""
        if isinstance(v, str):
            return self.intern("s:" + v)
        if (
            isinstance(v, float)
            and not isinstance(v, bool)
            and v.is_integer()
        ):
            v = int(v)
        return self.intern("j:" + json.dumps(v, sort_keys=True))

    def str_id(self, v: str) -> int:
        return self.intern("s:" + v)

    def str_lookup(self, v: str) -> int:
        return self.lookup("s:" + v)

    # -- precomputed predicates --------------------------------------------

    def regex_matches(self, pattern: str, entry_id: int) -> bool:
        cache = self._regex_cache.setdefault(pattern, {})
        hit = cache.get(entry_id)
        if hit is None:
            s = self.string(entry_id)
            if s.startswith("s:"):
                s = s[2:]
            try:
                hit = re.search(pattern, s) is not None
            except re.error:
                hit = False
            cache[entry_id] = hit
        return hit

    def prefix_matches(self, prefix: str, entry_id: int) -> bool:
        cache = self._prefix_cache.setdefault(prefix, {})
        hit = cache.get(entry_id)
        if hit is None:
            s = self.string(entry_id)
            if s.startswith("s:"):
                s = s[2:]
            hit = s.startswith(prefix)
            cache[entry_id] = hit
        return hit


class OverlayVocab(Vocab):
    """Ephemeral per-batch view over a base Vocab.

    Strings already in the base resolve to their base ids; novel strings
    intern LOCALLY with ids >= base_len and die with the overlay. This
    is what keeps the admission path sustainable: every webhook batch
    carries fresh object names, and interning them globally would grow
    the vocab (and every [V]-shaped device table) forever — per-batch
    table re-uploads and a memory leak. The driver ships the overlay's
    tiny table/pattern rows alongside the batch instead
    (StrTables.fill_overlay / PatternRegistry.classify_overlay), and the
    kernels gather two-level (base tables for ids < base_len, overlay
    blocks above).

    Implementation: CHAIN LOOKUP — the base dict resolves first (its
    entries below the base_len snapshot), misses intern into local
    structures with offset ids. Construction is O(1), not an
    O(|vocab|) copy per admission micro-batch (ADVICE r4: the copy cost
    several ms at the 100k-corpus steady state, on the latency path the
    overlay exists to protect). The base is never mutated; predicate
    lookups on base ids DELEGATE to the base (sharing its bounded
    memos), local ids memoize locally and die with the overlay. The
    native C encoder chains the same way (flatten.c intern with
    base_ids/base_len)."""

    def __init__(self, base: Vocab):
        self.base = base
        self.base_len = len(base._strs)
        self._ids: Dict[str, int] = {}  # local, values offset by base_len
        self._strs: List[str] = []  # local, position-indexed
        self._quantity: List[Optional[float]] = []
        self._regex_cache: Dict[str, Dict[int, bool]] = {}
        self._prefix_cache: Dict[str, Dict[int, bool]] = {}
        self._vid_quantity: Dict[int, Optional[float]] = {}

    def __len__(self) -> int:
        return self.base_len + len(self._strs)

    def intern(self, s: str) -> int:
        i = self.base._ids.get(s)
        if i is not None and i < self.base_len:
            return i
        j = self._ids.get(s)
        if j is None:
            j = self.base_len + len(self._strs)
            self._ids[s] = j
            self._strs.append(s)
            self._quantity.append(parse_quantity(s))
        return j

    def lookup(self, s: str) -> int:
        i = self.base._ids.get(s)
        if i is not None and i < self.base_len:
            return i
        return self._ids.get(s, -1)

    def string(self, i: int) -> str:
        if i < self.base_len:
            return self.base._strs[i]
        return self._strs[i - self.base_len]

    def quantity(self, i: int) -> Optional[float]:
        if i < self.base_len:
            return self.base._quantity[i]
        return self._quantity[i - self.base_len]

    def quantity_of_val_id(self, vid: int) -> Optional[float]:
        if vid < self.base_len:
            return self.base.quantity_of_val_id(vid)
        return super().quantity_of_val_id(vid)

    def regex_matches(self, pattern: str, entry_id: int) -> bool:
        if entry_id < self.base_len:
            return self.base.regex_matches(pattern, entry_id)
        return super().regex_matches(pattern, entry_id)

    def prefix_matches(self, prefix: str, entry_id: int) -> bool:
        if entry_id < self.base_len:
            return self.base.prefix_matches(prefix, entry_id)
        return super().prefix_matches(prefix, entry_id)

    @property
    def local_count(self) -> int:
        return len(self._strs)
