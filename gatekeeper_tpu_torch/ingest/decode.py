# Copied from gatekeeper_tpu/ingest/decode.py; no line below differs.
"""Schema-aware zero-copy AdmissionReview decode (docs/ingest.md).

The legacy front door pays `json.loads` → full dict tree → a second
full `flatten_leaves` walk per request before the encoder ever sees a
token row. This module walks the wire bytes ONCE: an incremental
recursive-descent scanner over a `memoryview` of the frame payload
that

  * builds the small request envelope (uid / kind / namespace /
    operation / userInfo / ...) as plain Python values — the fields
    every handler, exclusion check, and decision record reads;
  * emits the encoder's token rows `(schema_path, idx0, idx1, kind,
    raw, num)` for `request.object` / `request.oldObject` DIRECTLY
    during the scan, bit-for-bit what `flatten_leaves` would yield
    (same `esc_seg` escaping, same "#" array marker, same two-level
    index lift with saturation, same empty-object/array kinds);
  * lifts the feature-bearing subtrees the match kernel needs
    (`apiVersion`, `kind`, `metadata` — labels live there) into real
    dicts, and defers everything else (`spec`, `status`, `data`, ...)
    behind a `LazyObject`: a dict subclass that materializes from the
    retained wire bytes only when a cold path (host interpreter,
    shadow oracle, external-data key extraction) actually reaches in.

Fallback semantics are the contract that keeps verdicts byte-identical
to the dict path: ANY schema surprise — duplicate keys (json.loads
keeps the last one; rows would double), NaN/Infinity literals, lone
structural garbage, numeric overflow, invalid UTF-8 — raises
`DecodeSurprise` and the caller re-parses with plain `json.loads`
(route "fallback", counted in `ingest_decode_fallback_total`). The
scanner is deliberately STRICTER than json.loads: everything it
accepts it decodes identically, everything it is unsure about it
hands back.
"""

from __future__ import annotations

import json as _json
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..flatten.encoder import (
    K_BOOL,
    K_EMPTY_ARR,
    K_EMPTY_OBJ,
    K_NULL,
    K_NUM,
    K_STR,
    esc_seg,
)

__all__ = [
    "DecodeSurprise",
    "LazyObject",
    "decode_review",
    "scan_review",
]

# object-subtree keys parsed into real values during the scan: the
# match-feature encoder reads gvk + metadata.labels on every review,
# so these must never trigger a materialization
LIFTED_KEYS = frozenset(("apiVersion", "kind", "metadata"))

# rows: (schema_path, idx0, idx1, kind, raw_value, num_value) —
# exactly flatten_leaves' tuple shape, relative to the subtree root
Row = Tuple[str, int, int, int, Optional[Any], float]


class DecodeSurprise(Exception):
    """The scanner met wire bytes it will not vouch for. Reason slugs
    land in `ingest_decode_fallback_total{reason=}`."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class LazyObject(dict):
    """`request.object` decoded at wire speed: a REAL dict (isinstance
    checks all over the engine keep working) whose storage holds only
    the lifted subtrees, plus the scanned token rows and the raw wire
    bytes. Key listing / membership answers from the scanned key list
    without parsing; the first access to a deferred value re-parses
    the retained bytes with `json.loads` (identical semantics) and
    completes the storage in wire order. Any MUTATION (the mutation
    plane's patches, test scaffolding) forces materialization and
    drops the rows — stale rows can never reach the encoder."""

    __slots__ = ("_keys", "_preflat_rows", "_raw", "_mat", "_on_mat")

    def __init__(
        self,
        lifted: Dict[str, Any],
        keys: Tuple[str, ...],
        rows: List[Row],
        raw,
        on_materialize: Optional[Callable[[], None]] = None,
    ):
        super().__init__(lifted)
        self._keys: Optional[Tuple[str, ...]] = keys
        self._preflat_rows: Optional[List[Row]] = rows
        self._raw = raw
        self._mat = False
        self._on_mat = on_materialize

    # -- row emission (the flatten/encoder.py row-emit entry point) ----------

    def token_rows(self) -> Optional[List[Row]]:
        """The scanned leaf rows (flatten_leaves shape, subtree-
        relative), or None once a mutation invalidated them."""
        return self._preflat_rows

    # -- lazy materialization ------------------------------------------------

    def _materialize(self) -> None:
        if self._mat:
            return
        self._mat = True
        full = _json.loads(bytes(self._raw))
        # rebuild storage in WIRE order (lifted keys alone would leave
        # deferred keys appended at the end and change row order for
        # any later re-flatten)
        dict.clear(self)
        dict.update(self, full)
        if self._on_mat is not None:
            try:
                self._on_mat()
            except Exception:
                pass  # counters must never break an admission

    def _force(self) -> None:
        """Materialize AND invalidate: a caller is about to mutate."""
        self._materialize()
        self._preflat_rows = None
        self._keys = None

    # -- reads ---------------------------------------------------------------

    def __getitem__(self, k):
        try:
            return dict.__getitem__(self, k)
        except KeyError:
            if not self._mat and self._keys is not None and k in self._keys:
                self._materialize()
                return dict.__getitem__(self, k)
            raise

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def __contains__(self, k) -> bool:
        if self._keys is not None:
            return k in self._keys
        return dict.__contains__(self, k)

    def __iter__(self):
        if self._keys is not None:
            return iter(self._keys)
        return dict.__iter__(self)

    def __len__(self) -> int:
        if self._keys is not None:
            return len(self._keys)
        return dict.__len__(self)

    def keys(self):
        self._materialize()
        return dict.keys(self)

    def values(self):
        self._materialize()
        return dict.values(self)

    def items(self):
        self._materialize()
        return dict.items(self)

    def __eq__(self, other):
        # the hot-path probe is `obj != {}` (encode_review_features);
        # a LazyObject is non-empty by construction, so emptiness
        # never needs the bytes
        if isinstance(other, dict) and len(other) == 0:
            return len(self) == 0
        self._materialize()
        return dict.__eq__(self, other)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None  # dicts are unhashable; keep it that way

    def copy(self):
        self._materialize()
        return dict(dict.items(self))

    def __reduce__(self):
        # deepcopy/pickle walk C-level storage; hand them a plain,
        # fully-parsed dict instead
        self._materialize()
        return (dict, (dict(dict.items(self)),))

    def __repr__(self):
        if self._mat:
            return dict.__repr__(self)
        return (
            f"LazyObject(keys={list(self._keys or ())!r}, "
            f"lifted={sorted(dict.keys(self))!r})"
        )

    # -- mutations: materialize first, rows die ------------------------------

    def __setitem__(self, k, v):
        self._force()
        dict.__setitem__(self, k, v)

    def __delitem__(self, k):
        self._force()
        dict.__delitem__(self, k)

    def setdefault(self, k, default=None):
        self._force()
        return dict.setdefault(self, k, default)

    def update(self, *args, **kwargs):
        self._force()
        dict.update(self, *args, **kwargs)

    def pop(self, *args):
        self._force()
        return dict.pop(self, *args)

    def popitem(self):
        self._force()
        return dict.popitem(self)

    def clear(self):
        self._mat = True
        self._preflat_rows = None
        self._keys = None
        dict.clear(self)


# ---------------------------------------------------------------------------
# the scanner

_NUM_RE = re.compile(rb"-?(?:0|[1-9][0-9]*)(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?")
_PLAIN_RE = re.compile(rb'[^"\\\x00-\x1f]*')
_CTRL_RE = re.compile(rb"[\x00-\x1f]")
_HEX4_RE = re.compile(rb"[0-9a-fA-F]{4}")
_ESCAPES = {
    0x22: '"', 0x5C: "\\", 0x2F: "/", 0x62: "\b",
    0x66: "\f", 0x6E: "\n", 0x72: "\r", 0x74: "\t",
}


class _Scanner:
    __slots__ = ("data", "mv", "i", "n", "on_materialize")

    def __init__(
        self,
        data: bytes,
        start: int = 0,
        end: Optional[int] = None,
        on_materialize: Optional[Callable[[], None]] = None,
    ):
        self.data = data
        self.mv = memoryview(data)
        self.i = start
        self.n = len(data) if end is None else end
        self.on_materialize = on_materialize

    # -- lexical helpers -----------------------------------------------------

    def _ws(self) -> None:
        data, n, i = self.data, self.n, self.i
        while i < n and data[i] in (0x20, 0x09, 0x0A, 0x0D):
            i += 1
        self.i = i

    def _string(self) -> str:
        """Decode a JSON string; self.i is at the opening quote."""
        data, n = self.data, self.n
        i = self.i + 1
        j = data.find(b'"', i, n)
        if j < 0:
            raise DecodeSurprise("truncated_string")
        if data.find(b"\\", i, j) < 0:
            # no escapes before the first quote: the common case
            if _CTRL_RE.search(data, i, j):
                raise DecodeSurprise("control_char")
            try:
                s = str(self.mv[i:j], "utf-8")
            except UnicodeDecodeError:
                raise DecodeSurprise("bad_utf8")
            self.i = j + 1
            return s
        parts: List[str] = []
        while True:
            m = _PLAIN_RE.match(data, i, n)
            j = m.end()
            if j > i:
                try:
                    parts.append(str(self.mv[i:j], "utf-8"))
                except UnicodeDecodeError:
                    raise DecodeSurprise("bad_utf8")
            if j >= n:
                raise DecodeSurprise("truncated_string")
            c = data[j]
            if c == 0x22:
                self.i = j + 1
                return "".join(parts)
            if c != 0x5C:
                raise DecodeSurprise("control_char")
            if j + 1 >= n:
                raise DecodeSurprise("truncated_string")
            e = data[j + 1]
            if e == 0x75:  # \uXXXX (surrogate pairs combined, lone kept
                # — exactly json.loads' behavior)
                if j + 6 > n or _HEX4_RE.match(data, j + 2, j + 6) is None:
                    raise DecodeSurprise("bad_unicode_escape")
                cu = int(data[j + 2:j + 6], 16)
                i = j + 6
                if 0xD800 <= cu <= 0xDBFF and data.startswith(b"\\u", i):
                    if i + 6 <= n and _HEX4_RE.match(data, i + 2, i + 6):
                        lo = int(data[i + 2:i + 6], 16)
                        if 0xDC00 <= lo <= 0xDFFF:
                            cu = 0x10000 + ((cu - 0xD800) << 10) + (
                                lo - 0xDC00
                            )
                            i += 6
                parts.append(chr(cu))
            else:
                ch = _ESCAPES.get(e)
                if ch is None:
                    raise DecodeSurprise("bad_escape")
                parts.append(ch)
                i = j + 2

    def _expect(self, byte: int, reason: str) -> None:
        if self.i >= self.n or self.data[self.i] != byte:
            raise DecodeSurprise(reason)
        self.i += 1

    # -- the one recursive value walker --------------------------------------
    #
    # build=True constructs the Python value (json.loads-identical);
    # emit=True appends flatten_leaves-identical rows. The zero-copy
    # win is build=False, emit=True: deep subtrees never become dicts.

    def _value(
        self,
        build: bool,
        emit: bool,
        path: Optional[List[str]],
        i0: int,
        i1: int,
        rows: Optional[List[Row]],
    ):
        self._ws()
        data, n = self.data, self.n
        i = self.i
        if i >= n:
            raise DecodeSurprise("truncated")
        c = data[i]
        if c == 0x7B:  # {
            self.i = i + 1
            self._ws()
            obj: Optional[Dict[str, Any]] = {} if build else None
            if self.i < n and data[self.i] == 0x7D:
                self.i += 1
                if emit:
                    rows.append(
                        (".".join(path), i0, i1, K_EMPTY_OBJ, None, 0.0)
                    )
                return obj
            seen = set()
            while True:
                self._ws()
                if self.i >= n or data[self.i] != 0x22:
                    raise DecodeSurprise("bad_key")
                k = self._string()
                if k in seen:
                    # json.loads keeps the LAST duplicate; a single
                    # scan would emit rows for both — bail out
                    raise DecodeSurprise("dup_key")
                seen.add(k)
                self._ws()
                self._expect(0x3A, "bad_colon")
                if emit:
                    path.append(esc_seg(k))
                    v = self._value(build, True, path, i0, i1, rows)
                    path.pop()
                else:
                    v = self._value(build, False, path, i0, i1, rows)
                if build:
                    obj[k] = v
                self._ws()
                if self.i >= n:
                    raise DecodeSurprise("truncated")
                c2 = data[self.i]
                self.i += 1
                if c2 == 0x2C:
                    continue
                if c2 == 0x7D:
                    return obj
                raise DecodeSurprise("bad_object_sep")
        if c == 0x5B:  # [
            self.i = i + 1
            self._ws()
            arr: Optional[List[Any]] = [] if build else None
            if self.i < n and data[self.i] == 0x5D:
                self.i += 1
                if emit:
                    rows.append(
                        (".".join(path), i0, i1, K_EMPTY_ARR, None, 0.0)
                    )
                return arr
            if emit:
                path.append("#")
            j = 0
            while True:
                if emit:
                    # flatten_leaves' two-level index lift: indices
                    # past the second array level saturate
                    if i0 < 0:
                        a, b = j, -1
                    elif i1 < 0:
                        a, b = i0, j
                    else:
                        a, b = i0, i1
                else:
                    a, b = i0, i1
                v = self._value(build, emit, path, a, b, rows)
                if build:
                    arr.append(v)
                j += 1
                self._ws()
                if self.i >= n:
                    raise DecodeSurprise("truncated")
                c2 = data[self.i]
                self.i += 1
                if c2 == 0x2C:
                    continue
                if c2 == 0x5D:
                    break
                raise DecodeSurprise("bad_array_sep")
            if emit:
                path.pop()
            return arr
        if c == 0x22:
            s = self._string()
            if emit:
                rows.append((".".join(path), i0, i1, K_STR, s, 0.0))
            return s
        if c == 0x74:  # t
            if data.startswith(b"true", i):
                self.i = i + 4
                if emit:
                    rows.append((".".join(path), i0, i1, K_BOOL, True, 1.0))
                return True
            raise DecodeSurprise("bad_literal")
        if c == 0x66:  # f
            if data.startswith(b"false", i):
                self.i = i + 5
                if emit:
                    rows.append(
                        (".".join(path), i0, i1, K_BOOL, False, 0.0)
                    )
                return False
            raise DecodeSurprise("bad_literal")
        if c == 0x6E:  # n
            if data.startswith(b"null", i):
                self.i = i + 4
                if emit:
                    rows.append((".".join(path), i0, i1, K_NULL, None, 0.0))
                return None
            raise DecodeSurprise("bad_literal")
        m = _NUM_RE.match(data, i, n)
        if m is None or m.end() == i:
            # NaN/Infinity land here too: json.loads accepts them,
            # the rows could not represent them — fall back
            raise DecodeSurprise("bad_value")
        j2 = m.end()
        tb = data[i:j2]
        self.i = j2
        if b"." in tb or b"e" in tb or b"E" in tb:
            v: Any = float(tb)
        else:
            v = int(tb)
        if emit:
            try:
                num = float(v)
            except OverflowError:
                # flatten_leaves would raise at encode time; the dict
                # path must own that failure, not the scanner
                raise DecodeSurprise("num_overflow")
            rows.append((".".join(path), i0, i1, K_NUM, v, num))
        return v

    # -- AdmissionReview-shaped entry points ---------------------------------

    def _admission_object(self):
        """`request.object` / `request.oldObject`: the zero-copy
        subtree. Non-dict values (null, a scalar) and `{}` build
        normally; a non-empty dict becomes a LazyObject."""
        self._ws()
        if self.i >= self.n or self.data[self.i] != 0x7B:
            return self._value(True, False, None, -1, -1, None)
        start = self.i
        data, n = self.data, self.n
        self.i += 1
        self._ws()
        if self.i < n and data[self.i] == 0x7D:
            self.i += 1
            return {}
        rows: List[Row] = []
        lifted: Dict[str, Any] = {}
        keys: List[str] = []
        path: List[str] = []
        while True:
            self._ws()
            if self.i >= n or data[self.i] != 0x22:
                raise DecodeSurprise("bad_key")
            k = self._string()
            if k in keys:
                raise DecodeSurprise("dup_key")
            keys.append(k)
            self._ws()
            self._expect(0x3A, "bad_colon")
            path.append(esc_seg(k))
            if k in LIFTED_KEYS:
                lifted[k] = self._value(True, True, path, -1, -1, rows)
            else:
                self._value(False, True, path, -1, -1, rows)
            path.pop()
            self._ws()
            if self.i >= n:
                raise DecodeSurprise("truncated")
            c2 = data[self.i]
            self.i += 1
            if c2 == 0x2C:
                continue
            if c2 == 0x7D:
                break
            raise DecodeSurprise("bad_object_sep")
        raw = self.mv[start:self.i]
        return LazyObject(
            lifted, tuple(keys), rows, raw, self.on_materialize
        )

    def _special_object(self, level: str) -> Dict[str, Any]:
        """A built dict whose named keys route specially: the review's
        `request`, the request's `object`/`oldObject`."""
        self._expect(0x7B, "bad_object")
        out: Dict[str, Any] = {}
        data, n = self.data, self.n
        self._ws()
        if self.i < n and data[self.i] == 0x7D:
            self.i += 1
            return out
        while True:
            self._ws()
            if self.i >= n or data[self.i] != 0x22:
                raise DecodeSurprise("bad_key")
            k = self._string()
            if k in out:
                raise DecodeSurprise("dup_key")
            self._ws()
            self._expect(0x3A, "bad_colon")
            if level == "review" and k == "request":
                self._ws()
                if self.i < n and data[self.i] == 0x7B:
                    v: Any = self._special_object("request")
                else:
                    v = self._value(True, False, None, -1, -1, None)
            elif level == "request" and k in ("object", "oldObject"):
                v = self._admission_object()
            else:
                v = self._value(True, False, None, -1, -1, None)
            out[k] = v
            self._ws()
            if self.i >= n:
                raise DecodeSurprise("truncated")
            c2 = data[self.i]
            self.i += 1
            if c2 == 0x2C:
                continue
            if c2 == 0x7D:
                return out
            raise DecodeSurprise("bad_object_sep")

    def parse(self) -> Dict[str, Any]:
        self._ws()
        if self.i >= self.n or self.data[self.i] != 0x7B:
            raise DecodeSurprise("top_not_object")
        review = self._special_object("review")
        self._ws()
        if self.i != self.n:
            raise DecodeSurprise("trailing_data")
        return review


def scan_review(
    payload,
    on_materialize: Optional[Callable[[], None]] = None,
) -> Dict[str, Any]:
    """One-pass AdmissionReview scan. `payload` is bytes or any
    buffer; raises DecodeSurprise when the wire bytes need the
    json.loads path."""
    data = payload if isinstance(payload, bytes) else bytes(payload)
    try:
        return _Scanner(data, on_materialize=on_materialize).parse()
    except DecodeSurprise:
        raise
    except (UnicodeDecodeError, RecursionError, OverflowError) as e:
        raise DecodeSurprise(type(e).__name__.lower())


def decode_review(
    payload,
    zerocopy: bool = True,
    on_materialize: Optional[Callable[[], None]] = None,
) -> Tuple[Any, str, Optional[str]]:
    """(review, route, fallback_reason). Routes: "zerocopy" (scanner
    rows), "fallback" (scanner declined, json.loads answered),
    "legacy" (scanner not attempted). A payload json.loads itself
    rejects raises here exactly like the legacy HTTP body path."""
    data = payload if isinstance(payload, bytes) else bytes(payload)
    if not zerocopy:
        return _json.loads(data), "legacy", None
    try:
        return scan_review(data, on_materialize=on_materialize), (
            "zerocopy"
        ), None
    except DecodeSurprise as e:
        return _json.loads(data), "fallback", e.reason
