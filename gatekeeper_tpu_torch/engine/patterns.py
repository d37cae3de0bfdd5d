# Copied from gatekeeper_tpu/engine/patterns.py; only imports and the edits noted in this header differ.
"""Schema-path pattern registry: host-side path classification tables.

Token tables store one interned schema-path id per leaf
(gatekeeper_tpu/flatten/encoder.py). Compiled template programs select
tokens by *pattern* — a segment sequence where "#" matches an array level,
"*" matches exactly one segment (capturing it), and "**" matches any
(possibly empty) suffix. Membership and captures are resolved once per
distinct path string on the host and shipped to the device as lookup
tables indexed by path id:

    member[pattern_id, path_id]  -> bool
    capture[pattern_id, path_id] -> captured segment's "s:<seg>" vocab id

The device then classifies a token with two gathers — the TPU analog of
OPA's per-eval ref walking (vendor/.../opa/topdown/eval.go evalTree).
Tables grow append-only alongside the vocab; a generation counter lets
device caches invalidate cheaply.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..flatten.vocab import Vocab
from ..flatten.encoder import esc_seg, unesc_seg


@dataclass(frozen=True)
class Pattern:
    segs: Tuple[str, ...]  # literal | "#" | "*" | "?" | "**" (final only)

    @property
    def key(self) -> Tuple[str, ...]:
        return self.segs


def _match(pattern: Tuple[str, ...], segs: List[str]) -> Tuple[bool, Optional[str]]:
    """Returns (matches, captured segment for the first "*").

    "*" matches exactly one OBJECT-KEY segment (never the "#" array
    marker — object and array iteration branches must stay disjoint);
    "#" matches exactly the array marker; "?" matches exactly one
    segment of ANY kind (array marker or key, no capture — used by
    inventory-join mirror patterns where the partner's structure is
    unknown); "**" (final position) matches any remaining suffix
    including the empty one.
    """
    cap: Optional[str] = None
    pi = 0
    for si, seg in enumerate(segs):
        if pi >= len(pattern):
            return False, None
        p = pattern[pi]
        if p == "**":
            return True, cap
        if p == "*":
            if seg == "#":
                return False, None
            if cap is None:
                cap = seg
        elif p == "?":
            pass
        elif p == "#":
            if seg != "#":
                return False, None
        elif p != seg:
            return False, None
        pi += 1
    if pi == len(pattern):
        return True, cap
    if pi == len(pattern) - 1 and pattern[pi] == "**":
        return True, cap
    return False, None


class PatternRegistry:
    """Registered patterns + lazily grown [P, V] membership/capture tables."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self._patterns: List[Pattern] = []
        self._index: Dict[Tuple[str, ...], int] = {}
        self._member = np.zeros((0, 0), bool)
        self._capture = np.full((0, 0), -1, np.int32)
        self._scanned = 0  # vocab entries processed
        self.generation = 0

    def register(self, segs: Sequence[str]) -> int:
        key = tuple(segs)
        idx = self._index.get(key)
        if idx is not None:
            return idx
        idx = len(self._patterns)
        self._patterns.append(Pattern(key))
        self._index[key] = idx
        # grow rows and back-fill for already-scanned vocab entries
        v = self._member.shape[1]
        self._member = np.concatenate(
            [self._member, np.zeros((1, v), bool)], axis=0
        )
        self._capture = np.concatenate(
            [self._capture, np.full((1, v), -1, np.int32)], axis=0
        )
        for pid in range(min(self._scanned, v)):
            self._classify(idx, pid)
        self.generation += 1
        return idx

    def _classify(self, pat_idx: int, vocab_id: int) -> None:
        s = self.vocab.string(vocab_id)
        if not s.startswith("p:"):
            return
        segs = s[2:].split(".") if len(s) > 2 else []
        ok, cap = _match(self._patterns[pat_idx].segs, segs)
        if ok:
            self._member[pat_idx, vocab_id] = True
            if cap is not None:
                # captures are unescaped back to the raw object key so they
                # compare equal to interned parameter strings
                self._capture[pat_idx, vocab_id] = self.vocab.str_id(
                    unesc_seg(cap)
                )

    def sync(self) -> None:
        """Classify vocab entries added since the last sync. Note: str_id
        interning inside _classify may itself grow the vocab; loop until
        fixed point."""
        while True:
            n = len(self.vocab)
            if n == self._scanned and self._member.shape[1] >= n:
                return
            if self._member.shape[1] < n:
                pad = n - self._member.shape[1]
                self._member = np.concatenate(
                    [self._member, np.zeros((len(self._patterns), pad), bool)],
                    axis=1,
                )
                self._capture = np.concatenate(
                    [
                        self._capture,
                        np.full((len(self._patterns), pad), -1, np.int32),
                    ],
                    axis=1,
                )
            start = self._scanned
            self._scanned = n
            for vid in range(start, n):
                for pi in range(len(self._patterns)):
                    self._classify(pi, vid)
            self.generation += 1

    def classify_overlay(
        self, overlay, start: int, end: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (member [B, P] bool, capture [B, P] int32) rows for
        overlay entries [start, end) — the ephemeral counterpart of
        sync(), touching neither the base tables nor the base vocab.
        Captured segments intern into the OVERLAY; the caller loops
        while that grows it. Non-path entries (values) skip fast, so the
        per-batch cost is #new-paths x P, typically tiny."""
        P = len(self._patterns)
        B = end - start
        member = np.zeros((B, P), bool)
        capture = np.full((B, P), -1, np.int32)
        for j in range(B):
            s = overlay.string(start + j)
            if not s.startswith("p:"):
                continue
            segs = s[2:].split(".") if len(s) > 2 else []
            for pi, pat in enumerate(self._patterns):
                ok, cap = _match(pat.segs, segs)
                if ok:
                    member[j, pi] = True
                    if cap is not None:
                        capture[j, pi] = overlay.str_id(unesc_seg(cap))
        return member, capture

    @property
    def member(self) -> np.ndarray:
        return self._member

    @property
    def capture(self) -> np.ndarray:
        return self._capture

    @property
    def n_patterns(self) -> int:
        return len(self._patterns)

    def segs(self, idx: int) -> Tuple[str, ...]:
        return self._patterns[idx].segs
