# Copied from gatekeeper_tpu/flatten/encoder.py; only imports and the edits noted in this header differ.
# Edit: encode_token_table takes native=True (the C flattener, native/flatten.c)
# and runs the Python encoder only when the caller passes native=False or a
# row carries ingest preflattened rows; a native build or encode failure
# raises instead of falling back to the Python encoder.
"""Review/object encoders: JSON → dense numpy columns.

Two encodings:

1. **Match features** (`ReviewFeatures`/`FeatureBatch`): the per-review
   fields the constraint match kernel needs — gvk ids, effective namespace
   name, object/oldObject label pairs, resolved namespace-selector labels.
   Mirrors exactly what the reference's Rego matching library reads from
   `input.review` (pkg/target/target_template_source.go:131-386).

2. **Token table** (`TokenTable`): the generic flattened-leaf encoding
   `(schema_path, idx0, idx1, kind, value_id, value_num)` that compiled
   template kernels evaluate against. Array indices are lifted out of the
   path (two levels — enough for containers[i].ports[j]-shaped data) so a
   single schema-path id covers every element and per-element violations
   keep their index.

Padding is bucketed to powers of two so jit specializations are reused
across batches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from ..constraint import match as M
from .vocab import Vocab

# token value kinds
K_NULL, K_BOOL, K_NUM, K_STR, K_EMPTY_OBJ, K_EMPTY_ARR = 0, 1, 2, 3, 4, 5


def esc_seg(key: str) -> str:
    """Escape an object key for use as a path segment: "." would corrupt
    segment splitting (annotation keys like kubernetes.io/ingress.class)
    and a literal "#" would collide with the array marker."""
    if "%" in key or "." in key or key == "#":
        key = key.replace("%", "%25").replace(".", "%2E")
        if key == "#":
            key = "%23"
    return key


def unesc_seg(seg: str) -> str:
    if "%" not in seg:
        return seg
    return seg.replace("%23", "#").replace("%2E", ".").replace("%25", "%")


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Token table


def flatten_leaves(
    obj: Any,
) -> Iterator[Tuple[str, int, int, int, Optional[Any], float]]:
    """Yield (schema_path, idx0, idx1, kind, raw_value, num_value) leaves.

    schema_path joins object keys with "." and replaces array levels with
    "#"; idx0/idx1 carry the first two array indices (-1 when absent).
    Empty objects/arrays are emitted as their own kind so `count`/exists
    semantics survive flattening.
    """

    def rec(v: Any, path: List[str], idx: Tuple[int, int]):
        # row-emit entry point (docs/ingest.md): an ingest
        # LazyObject already carries the rows this walk would
        # produce, scanned straight off the wire — re-root them here
        # instead of re-walking (and re-materializing) the subtree.
        # Inside an array (idx set) rows would need index rewrites,
        # so that rare shape falls through to the normal dict walk.
        pre = getattr(v, "_preflat_rows", None)
        if pre is not None and idx == (-1, -1):
            if path:
                prefix = ".".join(path) + "."
                for rp, a, b, k, raw, num in pre:
                    yield prefix + rp, a, b, k, raw, num
            else:
                yield from pre
            return
        if isinstance(v, dict):
            if not v:
                yield ".".join(path), idx[0], idx[1], K_EMPTY_OBJ, None, 0.0
                return
            for k in v:
                path.append(esc_seg(str(k)))
                yield from rec(v[k], path, idx)
                path.pop()
        elif isinstance(v, list):
            if not v:
                yield ".".join(path), idx[0], idx[1], K_EMPTY_ARR, None, 0.0
                return
            path.append("#")
            for i, item in enumerate(v):
                if idx[0] < 0:
                    nidx = (i, -1)
                elif idx[1] < 0:
                    nidx = (idx[0], i)
                else:
                    nidx = idx  # >2 array levels: indices saturate
                yield from rec(item, path, nidx)
            path.pop()
        elif isinstance(v, bool):
            yield ".".join(path), idx[0], idx[1], K_BOOL, v, 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            yield ".".join(path), idx[0], idx[1], K_NUM, v, float(v)
        elif isinstance(v, str):
            yield ".".join(path), idx[0], idx[1], K_STR, v, 0.0
        elif v is None:
            yield ".".join(path), idx[0], idx[1], K_NULL, None, 0.0

    yield from rec(obj, [], (-1, -1))


@dataclass
class TokenTable:
    """Dense token columns for a batch of objects: shape [N, L]."""

    spath: np.ndarray  # int32 schema-path id (-1 pad)
    idx0: np.ndarray  # int32 first array index (-1 none)
    idx1: np.ndarray  # int32 second array index (-1 none)
    kind: np.ndarray  # int32 K_* (-1 pad)
    vid: np.ndarray  # int32 typed value id (-1 for non-scalar)
    vnum: np.ndarray  # float32 numeric view (quantities parsed)
    n_tokens: np.ndarray  # int32 [N] true token counts (pre-truncation)
    overflow: np.ndarray  # bool [N] true if object did not fit in L

    @property
    def shape(self):
        return self.spath.shape


def _carries_preflat(obj: Any) -> bool:
    """True when `obj` is — or holds at top level — an ingest
    LazyObject. The C flattener walks raw dict storage and would see
    only the lifted keys of a lazy object; such batches must take the
    Python path, where flatten_leaves re-roots the scanned rows."""
    if getattr(obj, "_preflat_rows", None) is not None:
        return True
    if type(obj) is dict:
        for v in obj.values():
            if getattr(v, "_preflat_rows", None) is not None:
                return True
    return False


def encode_token_table(
    objs: Sequence[Any], vocab: Vocab, max_len: Optional[int] = None,
    native: bool = True,
) -> TokenTable:
    """Token table of `objs`, interning into `vocab`. native=True encodes
    with the C flattener (built on first use; a build failure raises);
    native=False is the caller's request for the Python encoder."""
    objs = list(objs)
    if native and not any(_carries_preflat(o) for o in objs):
        return _encode_token_table_native(
            _flatten_native(), objs, vocab, max_len
        )
    rows = []
    for obj in objs:
        row = []
        for spath, i0, i1, kind, raw, num in flatten_leaves(obj):
            pid = vocab.intern("p:" + spath)
            if kind == K_STR:
                vid = vocab.str_id(raw)
                q = vocab.quantity_of_val_id(vid)
                num = q if q is not None else 0.0
            elif kind in (K_BOOL, K_NUM, K_NULL):
                vid = vocab.val_id(raw)
            else:
                vid = -1
            row.append((pid, i0, i1, kind, vid, num))
        rows.append(row)
    longest = max((len(r) for r in rows), default=1)
    L = max_len if max_len is not None else _bucket(max(longest, 1), lo=32)
    N = len(rows)
    spath = np.full((N, L), -1, np.int32)
    idx0 = np.full((N, L), -1, np.int32)
    idx1 = np.full((N, L), -1, np.int32)
    kind = np.full((N, L), -1, np.int32)
    vid = np.full((N, L), -1, np.int32)
    vnum = np.zeros((N, L), np.float32)
    n_tokens = np.zeros((N,), np.int32)
    overflow = np.zeros((N,), bool)
    for n, row in enumerate(rows):
        n_tokens[n] = len(row)
        if len(row) > L:
            overflow[n] = True
            row = row[:L]
        for l, (p, i0, i1, k, v, num) in enumerate(row):
            spath[n, l] = p
            idx0[n, l] = i0
            idx1[n, l] = i1
            kind[n, l] = k
            vid[n, l] = v
            vnum[n, l] = num
    return TokenTable(spath, idx0, idx1, kind, vid, vnum, n_tokens, overflow)


def _flatten_native():
    from ..native import load_flatten_native

    return load_flatten_native()


def _encode_token_table_native(
    native, objs: list, vocab: Vocab, max_len: Optional[int]
) -> TokenTable:
    """C flattener path: flat columns + row offsets from the extension,
    padded into [N, L] with vectorized scatter."""
    from .vocab import parse_quantity

    base = getattr(vocab, "base", None)
    if base is not None:
        # OverlayVocab chain mode: local structures + read-only base
        # dict; the C intern assigns offset ids exactly like
        # OverlayVocab.intern
        sp_b, i0_b, i1_b, k_b, v_b, num_b, off_b = native.encode_rows(
            objs, vocab._ids, vocab._strs, vocab._quantity,
            parse_quantity, base._ids, vocab.base_len,
        )
    else:
        sp_b, i0_b, i1_b, k_b, v_b, num_b, off_b = native.encode_rows(
            objs, vocab._ids, vocab._strs, vocab._quantity, parse_quantity
        )
    flat_sp = np.frombuffer(sp_b, np.int32)
    flat_i0 = np.frombuffer(i0_b, np.int32)
    flat_i1 = np.frombuffer(i1_b, np.int32)
    flat_k = np.frombuffer(k_b, np.int32)
    flat_v = np.frombuffer(v_b, np.int32)
    flat_num = np.frombuffer(num_b, np.float32)
    off = np.frombuffer(off_b, np.int32)
    N = len(objs)
    lens = off[1:] - off[:-1]
    longest = int(lens.max(initial=0))
    L = max_len if max_len is not None else _bucket(max(longest, 1), lo=32)
    overflow = lens > L
    n_tokens = lens.astype(np.int32)
    keep = np.minimum(lens, L).astype(np.int64)
    # (row, col) scatter indices for every kept token, fully vectorized:
    # cols restart at 0 per row (ramp minus per-row start), src follows
    # the flat row offsets
    rows_idx = np.repeat(np.arange(N), keep)
    starts = np.concatenate([[0], np.cumsum(keep)[:-1]]) if N else (
        np.zeros((0,), np.int64)
    )
    ramp = np.arange(int(keep.sum()), dtype=np.int64)
    cols_idx = ramp - np.repeat(starts, keep)
    src = np.repeat(off[:-1].astype(np.int64), keep) + cols_idx
    spath = np.full((N, L), -1, np.int32)
    idx0 = np.full((N, L), -1, np.int32)
    idx1 = np.full((N, L), -1, np.int32)
    kind = np.full((N, L), -1, np.int32)
    vid = np.full((N, L), -1, np.int32)
    vnum = np.zeros((N, L), np.float32)
    spath[rows_idx, cols_idx] = flat_sp[src]
    idx0[rows_idx, cols_idx] = flat_i0[src]
    idx1[rows_idx, cols_idx] = flat_i1[src]
    kind[rows_idx, cols_idx] = flat_k[src]
    vid[rows_idx, cols_idx] = flat_v[src]
    vnum[rows_idx, cols_idx] = flat_num[src]
    return TokenTable(
        spath, idx0, idx1, kind, vid, vnum, n_tokens, overflow.astype(bool)
    )


def mask_token_table(
    table: TokenTable,
    keep_id_fn: Callable[[int], bool],
    lo: int = 32,
) -> Tuple[TokenTable, int]:
    """Drop tokens whose schema-path vocab id fails `keep_id_fn`
    (statically-dead columns per the IR liveness analysis), compacting
    survivors to the front of each row and re-bucketing L. Returns the
    filtered table plus the number of token slots dropped.

    `overflow` is preserved from the input table, never recomputed: an
    overflowed row was truncated at the ORIGINAL L and may have lost
    live tokens, so it must keep routing to the interpreter regardless
    of how small it looks after filtering. `n_tokens` becomes the kept
    count (the filtered table's true occupancy).
    """
    sp = table.spath
    uniq = np.unique(sp)
    keep_ids = np.array(
        [int(p) for p in uniq if p >= 0 and keep_id_fn(int(p))],
        dtype=np.int32,
    )
    keep = np.isin(sp, keep_ids)
    skipped = int((sp >= 0).sum() - keep.sum())
    if skipped == 0:
        return table, 0
    N = sp.shape[0]
    kept = keep.sum(axis=1).astype(np.int64)
    L = _bucket(int(max(kept.max(initial=0), 1)), lo=lo)
    rows_idx, src_cols = np.nonzero(keep)  # row-major: order preserved
    starts = np.concatenate([[0], np.cumsum(kept)[:-1]]) if N else (
        np.zeros((0,), np.int64)
    )
    cols_idx = np.arange(int(kept.sum()), dtype=np.int64) - np.repeat(
        starts, kept
    )
    spath = np.full((N, L), -1, np.int32)
    idx0 = np.full((N, L), -1, np.int32)
    idx1 = np.full((N, L), -1, np.int32)
    kind = np.full((N, L), -1, np.int32)
    vid = np.full((N, L), -1, np.int32)
    vnum = np.zeros((N, L), np.float32)
    spath[rows_idx, cols_idx] = sp[rows_idx, src_cols]
    idx0[rows_idx, cols_idx] = table.idx0[rows_idx, src_cols]
    idx1[rows_idx, cols_idx] = table.idx1[rows_idx, src_cols]
    kind[rows_idx, cols_idx] = table.kind[rows_idx, src_cols]
    vid[rows_idx, cols_idx] = table.vid[rows_idx, src_cols]
    vnum[rows_idx, cols_idx] = table.vnum[rows_idx, src_cols]
    return (
        TokenTable(
            spath,
            idx0,
            idx1,
            kind,
            vid,
            vnum,
            kept.astype(np.int32),
            table.overflow.copy(),
        ),
        skipped,
    )


# ---------------------------------------------------------------------------
# Match features

_UNDEF = -1  # undefined id sentinel


@dataclass
class ReviewFeatures:
    """Per-review scalar/label features for the match kernel."""

    group_id: int
    kind_id: int
    kind_defined: bool  # review has a `kind` field at all (hoisting gate)
    is_ns: bool
    has_namespace: bool  # get_default(review, "namespace", "") != ""
    ns_name_id: int  # effective get_ns_name (or -1 undefined)
    obj_present: bool
    old_present: bool
    obj_labels: List[Tuple[int, int]]
    old_labels: List[Tuple[int, int]]
    nssel_defined: bool  # get_ns produced at least one candidate
    nssel_labels: List[Tuple[int, int]]  # primary candidate's labels
    # a second get_ns candidate with empty labels exists (the
    # `_unstable.namespace: false` partial-set case) or the primary itself
    # is empty — the kernel ORs in the selector-matches-empty-labels result
    nssel_empty: bool


def _label_pairs(labels: Any, vocab: Vocab) -> List[Tuple[int, int]]:
    if not isinstance(labels, dict):
        return []
    out = []
    for k, v in labels.items():
        out.append((vocab.str_id(str(k)), vocab.val_id(v)))
    return out


def _obj_labels(obj: Any) -> Any:
    meta = M.get_default(obj, "metadata", {})
    return M.get_default(meta, "labels", {})


def encode_review_features(
    review: Dict[str, Any], ns_cache: Dict[str, Any], vocab: Vocab
) -> ReviewFeatures:
    """Feature extraction mirroring match.py's field helpers bit-for-bit.

    `ns_cache` is data.external.<target>.cluster.v1.Namespace (audit and
    webhook reviews both resolve namespaceSelector through `get_ns`, with
    `_unstable.namespace` taking precedence)."""
    k = review.get("kind") if isinstance(review, dict) else None
    kind_defined = isinstance(review, dict) and "kind" in review
    k = k if isinstance(k, dict) else {}
    group = k.get("group")
    kind = k.get("kind")
    is_ns = kind_defined and group == "" and kind == "Namespace"

    ns_val = M.get_default(review, "namespace", "")
    has_namespace = ns_val != ""

    ns_name = M.get_ns_name(review) if kind_defined else M._MISSING
    ns_name_id = (
        vocab.str_id(ns_name) if isinstance(ns_name, str) else _UNDEF
    )

    obj = M.get_default(review, "object", {})
    old = M.get_default(review, "oldObject", {})
    obj_present = obj != {}
    old_present = old != {}

    if is_ns:
        # matches_nsselector for Namespace reviews routes through
        # any_labelselector_match over the object/oldObject labels — the
        # kernel reuses obj_labels/old_labels with the same 4-case logic,
        # so nssel_labels is unused here
        nssel_defined = True
        nssel_labels = []
        nssel_empty = False
    else:
        # matches_nsselector's non-Namespace clause hoists input.review.kind
        # into `not is_ns(...)`, so an undefined kind fails it outright
        cands = (
            M.get_ns_candidates(review, ns_cache) if kind_defined else []
        )
        nssel_defined = bool(cands)
        nssel_labels = []
        nssel_empty = False
        for cand in cands:
            meta = M.get_default(cand, "metadata", {})
            pairs = _label_pairs(M.get_default(meta, "labels", {}), vocab)
            if pairs and not nssel_labels:
                nssel_labels = pairs
            elif not pairs:
                nssel_empty = True

    return ReviewFeatures(
        group_id=vocab.str_id(group) if isinstance(group, str) else _UNDEF,
        kind_id=vocab.str_id(kind) if isinstance(kind, str) else _UNDEF,
        kind_defined=kind_defined,
        is_ns=is_ns,
        has_namespace=has_namespace,
        ns_name_id=ns_name_id,
        obj_present=obj_present,
        old_present=old_present,
        obj_labels=_label_pairs(_obj_labels(obj), vocab),
        old_labels=_label_pairs(_obj_labels(old), vocab),
        nssel_defined=nssel_defined,
        nssel_labels=nssel_labels,
        nssel_empty=nssel_empty if not is_ns else False,
    )


@dataclass
class FeatureBatch:
    """Stacked ReviewFeatures: arrays of shape [N] / [N, ML, 2]."""

    group_id: np.ndarray
    kind_id: np.ndarray
    kind_defined: np.ndarray
    is_ns: np.ndarray
    has_namespace: np.ndarray
    ns_name_id: np.ndarray
    obj_present: np.ndarray
    old_present: np.ndarray
    obj_labels: np.ndarray  # [N, ML, 2], -1 pad
    old_labels: np.ndarray
    nssel_defined: np.ndarray
    nssel_labels: np.ndarray
    nssel_empty: np.ndarray
    # [N] true when an explicit max_labels truncated any of this review's
    # label rows — truncated selectors can falsely miss; callers must
    # route flagged rows to the oracle path
    label_overflow: np.ndarray = None

    @property
    def n(self) -> int:
        return int(self.group_id.shape[0])


def _stack_labels(rows: List[List[Tuple[int, int]]], ml: int) -> np.ndarray:
    out = np.full((len(rows), ml, 2), -1, np.int32)
    for i, row in enumerate(rows):
        for j, (k, v) in enumerate(row[:ml]):
            out[i, j, 0] = k
            out[i, j, 1] = v
    return out


def batch_review_features(
    feats: Sequence[ReviewFeatures], max_labels: Optional[int] = None
) -> FeatureBatch:
    longest = max(
        (
            max(len(f.obj_labels), len(f.old_labels), len(f.nssel_labels))
            for f in feats
        ),
        default=1,
    )
    ml = max_labels if max_labels is not None else _bucket(max(longest, 1), lo=4)
    label_overflow = np.array(
        [
            max(len(f.obj_labels), len(f.old_labels), len(f.nssel_labels)) > ml
            for f in feats
        ],
        bool,
    )
    return FeatureBatch(
        group_id=np.array([f.group_id for f in feats], np.int32),
        kind_id=np.array([f.kind_id for f in feats], np.int32),
        kind_defined=np.array([f.kind_defined for f in feats], bool),
        is_ns=np.array([f.is_ns for f in feats], bool),
        has_namespace=np.array([f.has_namespace for f in feats], bool),
        ns_name_id=np.array([f.ns_name_id for f in feats], np.int32),
        obj_present=np.array([f.obj_present for f in feats], bool),
        old_present=np.array([f.old_present for f in feats], bool),
        obj_labels=_stack_labels([f.obj_labels for f in feats], ml),
        old_labels=_stack_labels([f.old_labels for f in feats], ml),
        nssel_defined=np.array([f.nssel_defined for f in feats], bool),
        nssel_labels=_stack_labels([f.nssel_labels for f in feats], ml),
        nssel_empty=np.array([f.nssel_empty for f in feats], bool),
        label_overflow=label_overflow,
    )
