# Copied from gatekeeper_tpu/engine/matchspec.py; only imports and the edits noted in this header differ.
"""Constraint spec.match → dense match tensors.

Compiles each constraint's match block (kinds/namespaces/excludedNamespaces/
scope/labelSelector/namespaceSelector — schema in pkg/target/target.go:
246-318) into padded int32 tensors consumed by the jitted match kernel.
Every encoding decision mirrors a clause of the reference matching library
(target_template_source.go) via the native oracle in constraint/match.py;
the differential test battery in tests/test_match_kernel.py enforces
bit-equality between the two.

Sentinel codes:
  -1  padding (row ignored)
  -2  wildcard "*" (kind selector group/kind)
  -3  invalid selector row (present but malformed -> never matches)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constraint import match as M
from ..flatten.vocab import Vocab

WILDCARD = -2
INVALID = -3

# scope codes
SCOPE_ABSENT, SCOPE_STAR, SCOPE_NAMESPACED, SCOPE_CLUSTER, SCOPE_INVALID = (
    0,
    1,
    2,
    3,
    4,
)

# matchExpression op codes (OP_ALWAYS_VIOLATED retained for kernel compat)
OP_IGNORE, OP_IN, OP_NOT_IN, OP_EXISTS, OP_NOT_EXISTS, OP_ALWAYS_VIOLATED = (
    0,
    1,
    2,
    3,
    4,
    5,
)


def _is_scalar(v):
    return v is None or isinstance(v, (str, int, float, bool))
_OP_CODES = {
    "In": OP_IN,
    "NotIn": OP_NOT_IN,
    "Exists": OP_EXISTS,
    "DoesNotExist": OP_NOT_EXISTS,
}


def _bucket(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class _Selector:
    invalid: bool
    ml_pairs: List[Tuple[int, int]]
    exprs: List[Tuple[int, int, int, List[int]]]  # (key, op, n_values, ids)


def _compile_selector(sel: Any, vocab: Vocab) -> _Selector:
    """LabelSelector -> pairs/expressions (target_template_source.go:213-230)."""
    ml = M.get_default(sel, "matchLabels", {})
    pairs: List[Tuple[int, int]] = []
    invalid = False
    if isinstance(ml, dict):
        for k, v in ml.items():
            pairs.append((vocab.str_id(str(k)), vocab.val_id(v)))
    elif ml not in ([], ""):
        invalid = True  # non-object matchLabels never match
    exprs: List[Tuple[int, int, int, List[int]]] = []
    me = M.get_default(sel, "matchExpressions", [])
    if isinstance(me, list):
        for e in me:
            if not isinstance(e, dict) or "operator" not in e or "key" not in e:
                continue
            op = e["operator"]
            code = _OP_CODES.get(op, OP_IGNORE)
            if code == OP_IGNORE:
                continue
            values = M.get_default(e, "values", [])
            key_id = vocab.str_id(str(e["key"]))
            # mirror the oracle's values normalization exactly
            # (match.py values_shape): n_values encodes `count(values)>0`,
            # ids are the reachable members
            count_pos, elems = M.values_shape(values)
            ids = [
                vocab.val_id(v) for v in elems if _is_scalar(v)
            ]
            nv = 1 if count_pos else 0
            exprs.append((key_id, code, nv, ids))
    return _Selector(invalid=invalid, ml_pairs=pairs, exprs=exprs)


@dataclass
class MatchSpecSet:
    """Stacked match tensors for C constraints (numpy; jnp-ready)."""

    # kind selectors, cross-product expanded: [C, K, 2]
    kind_rows: np.ndarray
    # namespaces / excludedNamespaces
    ns_has: np.ndarray  # [C] bool
    ns_ids: np.ndarray  # [C, M]
    excl_has: np.ndarray  # [C] bool
    excl_ids: np.ndarray  # [C, M2]
    scope: np.ndarray  # [C] int32
    # labelSelector
    lab_invalid: np.ndarray  # [C] bool
    lab_ml: np.ndarray  # [C, P, 2]
    lab_expr: np.ndarray  # [C, E, 3] (key, op, n_values)
    lab_expr_vals: np.ndarray  # [C, E, V]
    # namespaceSelector
    nssel_has: np.ndarray  # [C] bool
    nssel_matches_empty: np.ndarray  # [C] selector matches empty label set
    nssel_invalid: np.ndarray
    nssel_ml: np.ndarray
    nssel_expr: np.ndarray
    nssel_expr_vals: np.ndarray

    @property
    def n(self) -> int:
        return int(self.kind_rows.shape[0])


def _expand_kind_rows(match: Any) -> Optional[List[Tuple[int, int]]]:
    """Returns rows of (group, kind) raw strings / sentinels, or None for the
    default wildcard selector."""
    kinds = M.get_default(match, "kinds", None)
    if kinds is None:
        return None
    if not isinstance(kinds, list):
        return [(INVALID, INVALID)]
    rows: List[Tuple[Any, Any]] = []
    for ks in kinds:
        if not isinstance(ks, dict):
            continue
        groups = ks.get("apiGroups")
        kk = ks.get("kinds")
        if not isinstance(groups, list) or not isinstance(kk, list):
            rows.append((INVALID, INVALID))
            continue
        if not groups or not kk:
            rows.append((INVALID, INVALID))
            continue
        for g in groups:
            for k in kk:
                rows.append((g, k))
    if not rows:
        rows.append((INVALID, INVALID))
    return rows


def compile_match_specs(
    constraints: Sequence[Dict[str, Any]], vocab: Vocab
) -> MatchSpecSet:
    """Raw constraints -> tensors (the K8s identity translation)."""
    return compile_match_irs(
        [M.constraint_match(c) for c in constraints], vocab
    )


def compile_match_irs(
    matches: Sequence[Any], vocab: Vocab
) -> MatchSpecSet:
    """Pre-extracted match blocks -> tensors. Target handlers translate
    their public match schema into this module's field vocabulary first
    (docs/targets.md); the K8s handler's translation is the identity."""
    per: List[Dict[str, Any]] = []
    for match in matches:
        raw_rows = _expand_kind_rows(match)
        if raw_rows is None:
            rows = [(WILDCARD, WILDCARD)]
        else:
            rows = []
            for g, k in raw_rows:
                if g is INVALID:
                    rows.append((INVALID, INVALID))
                    continue
                gc = WILDCARD if g == "*" else (
                    vocab.str_id(g) if isinstance(g, str) else INVALID
                )
                kc = WILDCARD if k == "*" else (
                    vocab.str_id(k) if isinstance(k, str) else INVALID
                )
                rows.append((gc, kc))

        ns_has = M._has_field(match, "namespaces")
        nss = match.get("namespaces") if ns_has else None
        ns_ids = (
            [vocab.str_id(n) for n in nss if isinstance(n, str)]
            if isinstance(nss, list)
            else []
        )
        excl_has = M._has_field(match, "excludedNamespaces")
        excl = match.get("excludedNamespaces") if excl_has else None
        excl_ids = (
            [vocab.str_id(n) for n in excl if isinstance(n, str)]
            if isinstance(excl, list)
            else []
        )

        if not M._has_field(match, "scope"):
            scope = SCOPE_ABSENT
        else:
            scope = {
                "*": SCOPE_STAR,
                "Namespaced": SCOPE_NAMESPACED,
                "Cluster": SCOPE_CLUSTER,
            }.get(match.get("scope"), SCOPE_INVALID)

        lab = _compile_selector(M.get_default(match, "labelSelector", {}), vocab)
        nssel_has = M._has_field(match, "namespaceSelector")
        nssel_raw = M.get_default(match, "namespaceSelector", {})
        nssel = _compile_selector(nssel_raw, vocab)
        nssel_empty_ok = M.matches_label_selector(nssel_raw, {})

        per.append(
            dict(
                rows=rows,
                ns_has=ns_has,
                ns_ids=ns_ids,
                excl_has=excl_has,
                excl_ids=excl_ids,
                scope=scope,
                lab=lab,
                nssel_has=nssel_has,
                nssel=nssel,
                nssel_empty_ok=nssel_empty_ok,
            )
        )

    C = len(per)
    K = _bucket(max((len(p["rows"]) for p in per), default=1))
    NM = _bucket(max((len(p["ns_ids"]) for p in per), default=1))
    NE = _bucket(max((len(p["excl_ids"]) for p in per), default=1))

    def sel_dims(key):
        P = _bucket(max((len(p[key].ml_pairs) for p in per), default=1))
        E = _bucket(max((len(p[key].exprs) for p in per), default=1))
        V = _bucket(
            max(
                (len(e[3]) for p in per for e in p[key].exprs),
                default=1,
            )
        )
        return P, E, V

    LP, LE, LV = sel_dims("lab")
    SP, SE, SV = sel_dims("nssel")

    kind_rows = np.full((C, K, 2), -1, np.int32)
    ns_has = np.zeros((C,), bool)
    ns_ids = np.full((C, NM), -1, np.int32)
    excl_has = np.zeros((C,), bool)
    excl_ids = np.full((C, NE), -1, np.int32)
    scope = np.zeros((C,), np.int32)

    def pack_sel(P, E, V):
        return (
            np.zeros((C,), bool),
            np.full((C, P, 2), -1, np.int32),
            np.full((C, E, 3), -1, np.int32),
            np.full((C, E, V), -1, np.int32),
        )

    lab_invalid, lab_ml, lab_expr, lab_expr_vals = pack_sel(LP, LE, LV)
    nssel_invalid, nssel_ml, nssel_expr, nssel_expr_vals = pack_sel(SP, SE, SV)
    nssel_has_arr = np.zeros((C,), bool)
    nssel_matches_empty = np.zeros((C,), bool)

    def fill_sel(i, sel: _Selector, invalid, ml, expr, expr_vals):
        invalid[i] = sel.invalid
        for p, (k, v) in enumerate(sel.ml_pairs):
            ml[i, p, 0] = k
            ml[i, p, 1] = v
        for e, (k, op, nv, ids) in enumerate(sel.exprs):
            expr[i, e, 0] = k
            expr[i, e, 1] = op
            expr[i, e, 2] = nv
            for v, vid in enumerate(ids):
                expr_vals[i, e, v] = vid

    for i, p in enumerate(per):
        for r, (g, k) in enumerate(p["rows"]):
            kind_rows[i, r, 0] = g
            kind_rows[i, r, 1] = k
        ns_has[i] = p["ns_has"]
        for j, n in enumerate(p["ns_ids"]):
            ns_ids[i, j] = n
        excl_has[i] = p["excl_has"]
        for j, n in enumerate(p["excl_ids"]):
            excl_ids[i, j] = n
        scope[i] = p["scope"]
        fill_sel(i, p["lab"], lab_invalid, lab_ml, lab_expr, lab_expr_vals)
        nssel_has_arr[i] = p["nssel_has"]
        nssel_matches_empty[i] = p["nssel_empty_ok"]
        fill_sel(
            i, p["nssel"], nssel_invalid, nssel_ml, nssel_expr, nssel_expr_vals
        )

    return MatchSpecSet(
        kind_rows=kind_rows,
        ns_has=ns_has,
        ns_ids=ns_ids,
        excl_has=excl_has,
        excl_ids=excl_ids,
        scope=scope,
        lab_invalid=lab_invalid,
        lab_ml=lab_ml,
        lab_expr=lab_expr,
        lab_expr_vals=lab_expr_vals,
        nssel_has=nssel_has_arr,
        nssel_matches_empty=nssel_matches_empty,
        nssel_invalid=nssel_invalid,
        nssel_ml=nssel_ml,
        nssel_expr=nssel_expr,
        nssel_expr_vals=nssel_expr_vals,
    )
