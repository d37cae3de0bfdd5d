# Copied from gatekeeper_tpu/analysis/corpus.py; only this edit differs.
# Edit: the docstring names the template analyzer instead of the change
# that brought it.
"""Corpus-wide static analysis: the cross-plane semantic gate.

The template analyzer judges each ConstraintTemplate in isolation; this
module judges the *corpus* — templates + constraints + mutators +
providers together — and emits stable ``GK-C0xx`` diagnostics through
the same report/CLI/baseline machinery the per-plane linters use:

==========  ========  =====================================================
code        severity  meaning
==========  ========  =====================================================
GK-C001     error     template calls ``external_data`` naming a provider
                      that is not registered
GK-C002     error     constraint references a kind with no live template
GK-C003     warn      error-gated template (extdata_mode "err") consumes a
                      fail-open provider — the deny-on-error proof can
                      never fire because errors resolve open
GK-C004     error     constraint ``spec.parameters`` violates the template
                      CRD's openAPIV3Schema (wrong type / missing
                      required), with path provenance
GK-C005     warn      constraint parameter key unknown to the template's
                      declared schema (the permissive CRD validator lets
                      it through; a typo'd knob silently does nothing)
GK-C006     warn      dead match: the constraint's compiled match IR is
                      PROVABLY unsatisfiable — no review can select it
GK-C007     warn      shadowed constraint: another constraint with the
                      same kind, parameters and enforcementAction has a
                      provably-superset match
GK-C008     error     admission fight: a mutator's written (path, value)
                      provably lands in a validator's deny set — exhibited
                      by a concrete witness object that admits clean
                      pre-mutation and violates post-mutation
==========  ========  =====================================================

Provable vs heuristic (docs/analysis.md §Corpus analysis):

* GK-C001/C002/C004 are exact — registry lookups and schema walks.
* GK-C006 deadness uses a small set of *sound* proofs over the match
  IR (the same dict ``handler.match_ir`` hands the locality planner),
  each one verified against the ``constraint.match`` oracle semantics:

  - P1  ``kinds`` present with no satisfiable entry (an entry is
        satisfiable iff it is a dict whose ``apiGroups``/``kinds`` are
        both non-empty lists);
  - P2  ``scope`` present with a value outside {"*", "Cluster",
        "Namespaced"} — ``matches_scope`` rejects every review;
  - P3  ``scope: Namespaced`` (which defeats the empty-namespace
        selector bypass) plus ``namespaces`` that is non-list, empty,
        or an all-string list fully covered by string entries of
        ``excludedNamespaces``;
  - P4  ``labelSelector.matchLabels`` non-dict and not one of the
        empty forms the oracle tolerates;
  - P5  ``labelSelector.matchExpressions`` carrying a same-key
        contradiction (DoesNotExist vs Exists / In-with-values).

  Anything not covered by a proof is assumed live — the analyzer
  never guesses a constraint dead.
* GK-C007 superset is dimension-wise conservative (equal canonical IR
  fast path, else each dimension equal-or-strictly-looser); it can
  miss shadows, never invents them.
* GK-C008 is witness-based: the pair is only reported when a concrete
  review was constructed that both match blocks select, the mutator's
  ``apply`` actually changed it, and the template's violation rule
  (evaluated through the stock interpreter) fires on the mutated
  object but not the original. Pairs where no witness could be built
  are skipped, not guessed.

Verdict-safe static pruning: a dead constraint may be excluded from
``PartitionPlan`` dispatch rows ONLY when it also has no
``namespaceSelector`` — the autoreject path (a review whose namespace
context is missing) emits results for ns-selector constraints
*without consulting the match*, so excluding those would change
merged verdicts. ``CorpusReport.prunable_keys`` encodes exactly that:
``dead AND NOT match_needs_ns_selector``. Shadowed constraints only
warn — each live constraint owns its violation message.

``CorpusPlane`` is the serving-side wrapper: it recomputes the report
off the request path when the constraint/mutation churn generation
moves (debounced), exports ``corpus_diagnostics_total{code}`` gauges,
snapshots into ``/readyz`` ``stats.analysis.corpus``, and hands the
partition planner its generation-matched prunable key set.
"""

from __future__ import annotations

import copy
import json
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CORPUS_CODES",
    "CorpusDiagnostic",
    "CorpusLint",
    "CorpusReport",
    "CorpusPlane",
    "analyze_corpus",
    "corpus_from_docs",
    "corpus_from_live",
    "match_is_dead",
    "match_subsumes",
]

# stable code -> (severity, one-line meaning). Severity "error" fails
# an un-baselined run; "warn" reports but the subject still counts as
# flagged (the baseline pins both kinds).
CORPUS_CODES: Dict[str, Tuple[str, str]] = {
    "GK-C001": ("error", "external_data provider not registered"),
    "GK-C002": ("error", "constraint kind has no live template"),
    "GK-C003": ("warn", "error-gated template behind fail-open provider"),
    "GK-C004": ("error", "constraint parameters violate template schema"),
    "GK-C005": ("warn", "constraint parameter unknown to template schema"),
    "GK-C006": ("warn", "dead match: provably unsatisfiable"),
    "GK-C007": ("warn", "shadowed by a superset constraint"),
    "GK-C008": ("error", "mutator writes a value a validator denies"),
}

_SCOPE_VALUES = ("*", "Cluster", "Namespaced")


@dataclass
class CorpusDiagnostic:
    """One corpus finding, attached to one subject."""

    code: str
    subject: str  # "template:<Kind>" | "constraint:<Kind>/<name>" | ...
    message: str
    path: str = ""  # provenance (spec.parameters.labels[0], ...)

    @property
    def severity(self) -> str:
        return CORPUS_CODES.get(self.code, ("error", ""))[0]

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "code": self.code,
            "severity": self.severity,
            "subject": self.subject,
            "message": self.message,
        }
        if self.path:
            out["path"] = self.path
        return out

    def render(self) -> str:
        where = f" @ {self.path}" if self.path else ""
        return f"[{self.code}] {self.subject}{where}: {self.message}"


@dataclass
class CorpusLint:
    """Per-subject rollup (the MutatorLint/ProviderLint shape the CLI
    baseline machinery expects: id, source, codes, ok, render)."""

    id: str
    source: str = ""
    diagnostics: List[CorpusDiagnostic] = field(default_factory=list)

    def add(self, diag: CorpusDiagnostic) -> None:
        for d in self.diagnostics:
            if d.code == diag.code and d.message == diag.message:
                return
        self.diagnostics.append(diag)

    @property
    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})

    @property
    def ok(self) -> bool:
        return not self.diagnostics

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "source": self.source,
            "ok": self.ok,
            "codes": self.codes,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def render(self) -> str:
        if self.ok:
            return f"{self.id}: ok"
        lines = [f"{self.id}:"]
        for d in self.diagnostics:
            lines.append(f"  {d.render()}")
        return "\n".join(lines)


@dataclass
class CorpusReport:
    """Whole-corpus outcome: per-subject lints + the planner feeds."""

    lints: List[CorpusLint] = field(default_factory=list)
    # constraint keys ("Kind/name", the partition planner's row ids)
    dead_keys: List[str] = field(default_factory=list)
    # dead AND no namespaceSelector: safe to exclude from dispatch rows
    prunable_keys: List[str] = field(default_factory=list)
    # shadowed key -> the key that shadows it
    shadowed: Dict[str, str] = field(default_factory=dict)
    subjects: int = 0

    def lint_for(self, subject_id: str, source: str = "") -> CorpusLint:
        for lint in self.lints:
            if lint.id == subject_id:
                return lint
        lint = CorpusLint(id=subject_id, source=source)
        self.lints.append(lint)
        return lint

    @property
    def diagnostics(self) -> List[CorpusDiagnostic]:
        return [d for lint in self.lints for d in lint.diagnostics]

    @property
    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.diagnostics:
            out[d.code] = out.get(d.code, 0) + 1
        return out

    @property
    def ok(self) -> bool:
        return all(lint.ok for lint in self.lints)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "subjects": self.subjects,
            "ok": self.ok,
            "counts": self.counts(),
            "dead_keys": sorted(self.dead_keys),
            "prunable_keys": sorted(self.prunable_keys),
            "shadowed": dict(sorted(self.shadowed.items())),
            "lints": [lint.to_dict() for lint in self.lints],
        }

    def render(self) -> str:
        lines = []
        for lint in self.lints:
            if not lint.ok:
                lines.append(lint.render())
        counts = self.counts()
        summary = ", ".join(
            f"{c}={counts[c]}" for c in sorted(counts)
        ) or "clean"
        lines.append(
            f"corpus: {self.subjects} subject(s), {summary}; "
            f"dead={len(self.dead_keys)} prunable={len(self.prunable_keys)} "
            f"shadowed={len(self.shadowed)}"
        )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# dead-match proofs (sound against constraint.match oracle semantics)


def _kinds_entry_satisfiable(entry: Any) -> bool:
    """Mirror of any_kind_selector_matches' per-entry guard: an entry
    contributes a possible match iff it is a dict whose apiGroups and
    kinds are BOTH non-empty lists (a non-list side short-circuits the
    isinstance gate; an empty list can never contain "*" nor a name)."""
    if not isinstance(entry, dict):
        return False
    groups = entry.get("apiGroups", ["*"])
    kinds = entry.get("kinds", ["*"])
    if not isinstance(groups, list) or not isinstance(kinds, list):
        return False
    return bool(groups) and bool(kinds)


def match_is_dead(ir: Any) -> Tuple[bool, str]:
    """(dead, proof) — True only when NO review can satisfy the match
    IR, by one of the sound proofs P1..P5 documented in the module
    docstring. Non-dict IRs (opaque custom-target match forms) are
    never judged."""
    if not isinstance(ir, dict):
        return False, ""

    # P1: kinds present but no entry satisfiable
    if "kinds" in ir:
        kinds = ir.get("kinds")
        if not isinstance(kinds, list):
            return True, "P1: kinds is not a list"
        if not any(_kinds_entry_satisfiable(e) for e in kinds):
            return True, "P1: no satisfiable kinds entry"

    # P2: scope present with an unrecognized value -> matches_scope
    # returns False for every review (including null / wrong case)
    if "scope" in ir and ir.get("scope") not in _SCOPE_VALUES:
        return True, f"P2: invalid scope {ir.get('scope')!r}"

    # P3: Namespaced scope forces review.namespace != "", which defeats
    # the empty-namespace selector bypass — the namespaces list is then
    # load-bearing for every candidate review
    if ir.get("scope") == "Namespaced" and "namespaces" in ir:
        nss = ir.get("namespaces")
        if not isinstance(nss, list):
            return True, "P3: namespaces is not a list"
        if not nss:
            return True, "P3: namespaces is empty"
        excl = ir.get("excludedNamespaces")
        if (
            isinstance(excl, list)
            and all(isinstance(n, str) for n in nss)
            and all(
                any(isinstance(e, str) and e == n for e in excl)
                for n in nss
            )
        ):
            return True, "P3: namespaces fully excluded"

    sel = ir.get("labelSelector")
    if isinstance(sel, dict):
        # P4: non-dict matchLabels (outside the tolerated empty forms)
        # makes matches_label_selector reject every object
        if "matchLabels" in sel:
            ml = sel.get("matchLabels")
            if not isinstance(ml, dict) and ml not in ([], ""):
                return True, "P4: matchLabels is not an object"
        # P5: same-key contradiction in matchExpressions
        exprs = sel.get("matchExpressions")
        if isinstance(exprs, list):
            absent_keys = set()
            present_keys = set()
            for e in exprs:
                if not isinstance(e, dict) or "operator" not in e:
                    continue
                key = e.get("key")
                if not isinstance(key, str):
                    continue
                op = e.get("operator")
                if op == "DoesNotExist":
                    absent_keys.add(key)
                elif op == "Exists":
                    present_keys.add(key)
                elif op == "In":
                    # In with a non-empty values list violates when the
                    # key is absent (count positive + no match)
                    vals = e.get("values")
                    if isinstance(vals, (list, dict, str)) and vals:
                        present_keys.add(key)
            clash = absent_keys & present_keys
            if clash:
                k = sorted(clash)[0]
                return True, f"P5: contradictory selector on key {k!r}"

    return False, ""


# ---------------------------------------------------------------------------
# subsumption (conservative dimension-wise superset)


def _canon(value: Any) -> str:
    return json.dumps(value, sort_keys=True, default=str)


def _dim_superset_kinds(a: Any, b: Any, present_a: bool, present_b: bool
                        ) -> bool:
    if not present_a:
        return True  # absent = wildcard
    if not present_b:
        # A constrains kinds, B doesn't: A superset only if A contains
        # an explicit full wildcard entry
        return isinstance(a, list) and any(
            isinstance(e, dict)
            and "*" in (e.get("apiGroups") or [])
            and "*" in (e.get("kinds") or [])
            for e in a
        )
    if _canon(a) == _canon(b):
        return True
    if not isinstance(a, list) or not isinstance(b, list):
        return False
    if any(
        isinstance(e, dict)
        and "*" in (e.get("apiGroups") or [])
        and "*" in (e.get("kinds") or [])
        for e in a
    ):
        return True
    # entry-wise containment by canonical equality
    a_set = {_canon(e) for e in a}
    return all(_canon(e) in a_set for e in b)


def _dim_superset_namespaces(a: Any, b: Any, present_a: bool,
                             present_b: bool) -> bool:
    if not present_a:
        return True
    if not present_b:
        return False
    if _canon(a) == _canon(b):
        return True
    if not isinstance(a, list) or not isinstance(b, list):
        return False
    if not all(isinstance(n, str) for n in a + b):
        return False
    return set(b) <= set(a)


def match_subsumes(a_ir: Any, b_ir: Any) -> bool:
    """True when A's match provably selects a superset of B's. Equal
    canonical IR is the fast path; otherwise every dimension must be
    equal-or-looser on A's side. Conservative: False on anything not
    provably looser (opaque IRs, selector differences)."""
    if _canon(a_ir) == _canon(b_ir):
        return True
    if not isinstance(a_ir, dict) or not isinstance(b_ir, dict):
        return False

    if not _dim_superset_kinds(
        a_ir.get("kinds"), b_ir.get("kinds"),
        "kinds" in a_ir, "kinds" in b_ir,
    ):
        return False

    # scope: equal, or A absent/wildcard
    if "scope" in a_ir:
        if a_ir.get("scope") == "*":
            pass
        elif "scope" not in b_ir or a_ir.get("scope") != b_ir.get("scope"):
            return False

    if not _dim_superset_namespaces(
        a_ir.get("namespaces"), b_ir.get("namespaces"),
        "namespaces" in a_ir, "namespaces" in b_ir,
    ):
        return False

    # excludedNamespaces: A must exclude a subset of what B excludes
    if "excludedNamespaces" in a_ir:
        ea, eb = a_ir.get("excludedNamespaces"), b_ir.get(
            "excludedNamespaces"
        )
        if _canon(ea) != _canon(eb):
            if not (
                isinstance(ea, list)
                and isinstance(eb, list)
                and all(isinstance(n, str) for n in ea + eb)
                and set(ea) <= set(eb)
            ):
                return False

    # selectors: must be canonically equal (or absent on A's side); the
    # namespaceSelector also drives the autoreject path, so only exact
    # agreement is treated as comparable
    for dim in ("labelSelector", "namespaceSelector"):
        if dim in a_ir or dim in b_ir:
            if _canon(a_ir.get(dim)) != _canon(b_ir.get(dim)):
                if dim == "labelSelector" and dim not in a_ir:
                    continue  # absent labelSelector matches everything
                return False
    return True


# ---------------------------------------------------------------------------
# witness construction for the mutate<->validate fight pass


def _first_concrete_kind(ir: Any) -> Optional[Tuple[str, str]]:
    """(group, kind) the match accepts, preferring concrete names."""
    if not isinstance(ir, dict) or "kinds" not in ir:
        return "", "Pod"
    kinds = ir.get("kinds")
    if not isinstance(kinds, list):
        return None
    wildcard = None
    for e in kinds:
        if not _kinds_entry_satisfiable(e):
            continue
        groups = e.get("apiGroups", ["*"])
        names = e.get("kinds", ["*"])
        g = next((x for x in groups if x != "*"), None)
        k = next((x for x in names if x != "*"), None)
        if not isinstance(g, str):
            g = "" if "*" in groups else None
        if g is None:
            continue
        if k is None and "*" in names:
            wildcard = (g, "Pod")
            continue
        if isinstance(k, str):
            return g, k
    return wildcard


def _witness_for_match(ir: Any) -> Optional[Dict[str, Any]]:
    """A minimal gkReview dict the match IR selects; None when one
    cannot be constructed structurally (namespaceSelector needs
    namespace objects; opaque IRs are not guessed)."""
    if not isinstance(ir, dict):
        return None
    if "namespaceSelector" in ir:
        return None
    dead, _why = match_is_dead(ir)
    if dead:
        return None
    gk = _first_concrete_kind(ir)
    if gk is None:
        return None
    group, kind = gk
    scope = ir.get("scope")
    if scope not in (None, *_SCOPE_VALUES):
        return None
    ns = ""
    if scope != "Cluster":
        ns = "default"
        nss = ir.get("namespaces")
        if isinstance(nss, list):
            str_ns = [n for n in nss if isinstance(n, str)]
            if not str_ns:
                return None
            ns = str_ns[0]
        excl = ir.get("excludedNamespaces")
        if isinstance(excl, list) and ns in [
            e for e in excl if isinstance(e, str)
        ]:
            return None
    labels: Dict[str, Any] = {}
    sel = ir.get("labelSelector")
    if isinstance(sel, dict):
        ml = sel.get("matchLabels")
        if isinstance(ml, dict):
            if not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in ml.items()
            ):
                return None
            labels.update(ml)
        exprs = sel.get("matchExpressions")
        if isinstance(exprs, list) and exprs:
            for e in exprs:
                if not isinstance(e, dict) or "operator" not in e:
                    continue
                op, key = e.get("operator"), e.get("key")
                if not isinstance(key, str):
                    return None
                if op in ("In",):
                    vals = e.get("values")
                    if isinstance(vals, list) and any(
                        isinstance(v, str) for v in vals
                    ):
                        labels[key] = next(
                            v for v in vals if isinstance(v, str)
                        )
                    else:
                        return None
                elif op == "Exists":
                    labels.setdefault(key, "x")
                elif op in ("DoesNotExist", "NotIn"):
                    if key in labels:
                        return None
                else:
                    return None
    obj: Dict[str, Any] = {
        "apiVersion": f"{group}/v1" if group else "v1",
        "kind": kind,
        "metadata": {"name": "corpus-witness"},
    }
    if labels:
        obj["metadata"]["labels"] = dict(labels)
    if ns:
        obj["metadata"]["namespace"] = ns
    review: Dict[str, Any] = {
        "kind": {"group": group, "version": "v1", "kind": kind},
        "operation": "CREATE",
        "name": "corpus-witness",
        "object": obj,
    }
    if ns:
        review["namespace"] = ns
    return review


def _merge_witness(
    c_ir: Any, m_match: Dict[str, Any]
) -> Optional[Dict[str, Any]]:
    """Witness review selected by BOTH the constraint IR and the
    mutator match, or None. Strategy: build from the tighter merge of
    the two dicts; bail on any dimension both sides constrain
    differently (provably-disjoint or just not worth guessing)."""
    if not isinstance(c_ir, dict) or not isinstance(m_match, dict):
        return None
    merged: Dict[str, Any] = {}
    for dim in (
        "kinds", "scope", "namespaces", "excludedNamespaces",
        "labelSelector", "namespaceSelector",
    ):
        in_c, in_m = dim in c_ir, dim in m_match
        if in_c and in_m:
            if _canon(c_ir.get(dim)) != _canon(m_match.get(dim)):
                if dim == "namespaces":
                    a, b = c_ir.get(dim), m_match.get(dim)
                    if isinstance(a, list) and isinstance(b, list):
                        common = [
                            n for n in a
                            if isinstance(n, str) and n in b
                        ]
                        if common:
                            merged[dim] = common
                            continue
                elif dim == "excludedNamespaces":
                    a, b = c_ir.get(dim), m_match.get(dim)
                    if isinstance(a, list) and isinstance(b, list):
                        merged[dim] = a + b
                        continue
                return None
            merged[dim] = c_ir.get(dim)
        elif in_c:
            merged[dim] = c_ir.get(dim)
        elif in_m:
            merged[dim] = m_match.get(dim)
    return _witness_for_match(merged)


# ---------------------------------------------------------------------------
# the corpus pass


@dataclass
class _TemplateInfo:
    kind: str
    source: str
    template: Optional[Dict[str, Any]]  # raw doc (offline) or None
    report: Any  # VectorizabilityReport
    crd: Any  # templates.CRD or None when uninstantiable


def _constraint_key(c: Dict[str, Any]) -> str:
    name = ((c.get("metadata") or {}).get("name")) or "?"
    return f"{c.get('kind', '?')}/{name}"


def _params_schema(crd: Any) -> Optional[Dict[str, Any]]:
    schema = getattr(crd, "schema", None)
    if not isinstance(schema, dict):
        return None
    spec = (schema.get("properties") or {}).get("spec")
    if not isinstance(spec, dict):
        return None
    params = (spec.get("properties") or {}).get("parameters")
    return params if isinstance(params, dict) else None


def _unknown_keys(
    value: Any, schema: Optional[Dict[str, Any]], path: str
) -> List[str]:
    """Strict unknown-field walk: keys absent from a declared
    ``properties`` map (the permissive CRD validator only rejects them
    under an explicit additionalProperties: false)."""
    out: List[str] = []
    if not isinstance(schema, dict) or not isinstance(value, dict):
        return out
    props = schema.get("properties")
    addl = schema.get("additionalProperties")
    if isinstance(props, dict) and addl in (None, False):
        for k in sorted(value, key=str):
            if k not in props:
                out.append(f"{path}.{k}" if path else str(k))
            else:
                out.extend(
                    _unknown_keys(
                        value[k], props[k],
                        f"{path}.{k}" if path else str(k),
                    )
                )
    items = schema.get("items")
    if isinstance(items, dict) and isinstance(value, list):
        for i, v in enumerate(value):
            out.extend(_unknown_keys(v, items, f"{path}[{i}]"))
    return out


def _eval_violations(
    template_doc: Dict[str, Any],
    constraint: Dict[str, Any],
    review: Dict[str, Any],
) -> Optional[int]:
    """Violation count for one (template, constraint, review) through
    a throwaway stock-interpreter client; None when evaluation could
    not run (invalid template, engine error). Hermetic: never touches
    live serving state."""
    try:
        from ..constraint.client import Backend
        from ..constraint.driver import RegoDriver
        from ..constraint.target import AdmissionRequest, K8sValidationTarget

        client = Backend(RegoDriver()).new_client(K8sValidationTarget())
        client.add_template(template_doc)
        client.add_constraint(constraint)
        responses = client.review(AdmissionRequest(request=review))
        return sum(
            len(r.results) for r in responses.by_target.values()
        )
    except Exception:
        return None


def analyze_corpus(
    templates: Sequence[_TemplateInfo],
    constraints: Sequence[Tuple[str, Dict[str, Any]]],
    mutators: Sequence[Tuple[str, Any]],  # (source, Mutator object)
    providers: Dict[str, bool],  # name -> fail_open
    handler: Any = None,
    max_fight_pairs: int = 256,
) -> CorpusReport:
    """The whole-corpus pass. ``templates`` carry their analyzer
    report + CRD; ``mutators`` are typed Mutator objects; ``providers``
    maps registered names to their fail-open bit."""
    if handler is None:
        from ..constraint.target import K8sValidationTarget

        handler = K8sValidationTarget()

    report = CorpusReport()
    by_kind = {t.kind: t for t in templates}
    report.subjects = (
        len(templates) + len(constraints) + len(mutators) + len(providers)
    )
    # every linted subject gets a row (clean ones included) so the
    # baseline manifest pins the whole corpus, not just the flagged tail
    for t in templates:
        report.lint_for(f"template:{t.kind}", t.source)
    for src, c in constraints:
        report.lint_for(f"constraint:{_constraint_key(c)}", src)
    for m_src, m in mutators:
        report.lint_for(f"mutator:{getattr(m, 'id', '?')}", m_src)

    # -- pass 1: referential integrity --------------------------------------
    for t in templates:
        subject = f"template:{t.kind}"
        rep = t.report
        if rep is None:
            continue
        for prov in rep.external_providers():
            if prov not in providers:
                report.lint_for(subject, t.source).add(CorpusDiagnostic(
                    code="GK-C001",
                    subject=subject,
                    message=(
                        f"external_data names provider {prov!r} which is "
                        f"not registered"
                    ),
                ))
            elif rep.extdata_mode() == "err" and providers.get(prov):
                report.lint_for(subject, t.source).add(CorpusDiagnostic(
                    code="GK-C003",
                    subject=subject,
                    message=(
                        f"error-gated external_data consumes fail-open "
                        f"provider {prov!r}: provider errors resolve "
                        f"open, so the deny-on-error path never fires"
                    ),
                ))

    for src, c in constraints:
        key = _constraint_key(c)
        subject = f"constraint:{key}"
        kind = c.get("kind")
        t = by_kind.get(kind) if isinstance(kind, str) else None
        if t is None:
            report.lint_for(subject, src).add(CorpusDiagnostic(
                code="GK-C002",
                subject=subject,
                message=f"no live template for constraint kind {kind!r}",
            ))
            continue

        # -- pass 2: parameter type-check against the CRD schema ------------
        schema = _params_schema(t.crd)
        params = (c.get("spec") or {}).get("parameters")
        if schema is not None:
            from ..constraint.templates import validate_json_schema

            for err in validate_json_schema(
                params, schema, path="spec.parameters"
            ):
                report.lint_for(subject, src).add(CorpusDiagnostic(
                    code="GK-C004",
                    subject=subject,
                    message=err,
                    path="spec.parameters",
                ))
            for unknown in _unknown_keys(
                params, schema, "spec.parameters"
            ):
                report.lint_for(subject, src).add(CorpusDiagnostic(
                    code="GK-C005",
                    subject=subject,
                    message=(
                        f"parameter {unknown} is unknown to "
                        f"{t.kind}'s schema (silently ignored)"
                    ),
                    path=unknown,
                ))

    # -- pass 3: dead-match proofs + subsumption ----------------------------
    from ..constraint.match import match_needs_ns_selector

    irs: Dict[str, Any] = {}
    live_constraints = [
        (src, c) for src, c in constraints
        if isinstance(c.get("kind"), str) and c.get("kind") in by_kind
    ]
    for src, c in live_constraints:
        key = _constraint_key(c)
        subject = f"constraint:{key}"
        try:
            ir = handler.match_ir(c)
        except Exception:
            continue
        irs[key] = ir
        dead, proof = match_is_dead(ir)
        if dead:
            report.dead_keys.append(key)
            if not match_needs_ns_selector(ir):
                # no namespaceSelector -> no autoreject results either:
                # excluding the row cannot change any merged verdict
                report.prunable_keys.append(key)
            report.lint_for(subject, src).add(CorpusDiagnostic(
                code="GK-C006",
                subject=subject,
                message=f"match is provably unsatisfiable ({proof})",
                path="spec.match",
            ))

    from ..constraint.hooks import enforcement_action, constraint_parameters

    dead_set = set(report.dead_keys)
    for i, (src_b, b) in enumerate(live_constraints):
        key_b = _constraint_key(b)
        if key_b in dead_set or key_b not in irs:
            continue
        for j, (_src_a, a) in enumerate(live_constraints):
            if i == j:
                continue
            key_a = _constraint_key(a)
            if key_a in dead_set or key_a not in irs:
                continue
            if a.get("kind") != b.get("kind"):
                continue
            if _canon(constraint_parameters(a)) != _canon(
                constraint_parameters(b)
            ):
                continue
            if enforcement_action(a) != enforcement_action(b):
                continue
            if not match_subsumes(irs[key_a], irs[key_b]):
                continue
            if _canon(irs[key_a]) == _canon(irs[key_b]) and key_a > key_b:
                continue  # identical matches: only the later name warns
            subject = f"constraint:{key_b}"
            report.shadowed[key_b] = key_a
            report.lint_for(subject, src_b).add(CorpusDiagnostic(
                code="GK-C007",
                subject=subject,
                message=(
                    f"shadowed by {key_a}: same template, parameters "
                    f"and enforcementAction with a superset match"
                ),
                path="spec.match",
            ))
            break

    # -- pass 4: mutate<->validate interference -----------------------------
    pairs_tried = 0
    for m_src, m in mutators:
        m_match = getattr(m, "match", None)
        if not isinstance(m_match, dict):
            continue
        for src, c in live_constraints:
            key = _constraint_key(c)
            if key in dead_set or key not in irs:
                continue
            t = by_kind.get(c.get("kind"))
            if t is None or t.template is None or t.report is None:
                continue
            # only validators the analyzer can evaluate hermetically:
            # external_data calls would fetch during witness evaluation
            if t.report.external_calls or not t.report.compilable:
                continue
            if pairs_tried >= max_fight_pairs:
                break
            pairs_tried += 1
            witness = _merge_witness(irs[key], m_match)
            if witness is None:
                continue
            obj = witness.get("object")
            gvk = witness.get("kind") or {}
            try:
                if not m.applies_to(
                    gvk.get("group", ""), gvk.get("version", ""),
                    gvk.get("kind", ""),
                ):
                    continue
                mutated, changed = m.apply(copy.deepcopy(obj), witness)
            except Exception:
                continue
            if not changed:
                continue
            pre = _eval_violations(t.template, c, witness)
            if pre is None or pre > 0:
                continue
            post_review = dict(witness)
            post_review["object"] = mutated
            post = _eval_violations(t.template, c, post_review)
            if post is None or post == 0:
                continue
            mid = getattr(m, "id", "?")
            subject = f"mutator:{mid}"
            report.lint_for(subject, m_src).add(CorpusDiagnostic(
                code="GK-C008",
                subject=subject,
                message=(
                    f"admission fight with {key}: writing "
                    f"{getattr(m, 'location', '?')} turns a clean "
                    f"witness into a violation — every matching "
                    f"request 500s at the mutate/validate fixpoint"
                ),
                path=str(getattr(m, "location", "")),
            ))

    report.dead_keys.sort()
    report.prunable_keys.sort()
    return report


# ---------------------------------------------------------------------------
# corpus assembly (offline docs / live registries)


def corpus_from_docs(
    template_docs: Sequence[Tuple[str, Dict[str, Any]]],
    constraint_docs: Sequence[Tuple[str, Dict[str, Any]]],
    mutator_docs: Sequence[Tuple[str, Dict[str, Any]]],
    provider_docs: Sequence[Tuple[str, Dict[str, Any]]],
    max_fight_pairs: int = 256,
) -> CorpusReport:
    """Offline entry: raw YAML docs (the CLI collectors' output)."""
    from ..constraint.target import K8sValidationTarget
    from ..constraint.templates import ConstraintTemplate, create_crd
    from ..mutation.mutators import MutatorError, mutator_from_obj
    from .analyzer import analyze_template

    handler = K8sValidationTarget()
    templates: List[_TemplateInfo] = []
    for src, doc in template_docs:
        rep = analyze_template(doc)
        crd = None
        try:
            ct = ConstraintTemplate.from_dict(doc)
            crd = create_crd(ct, handler.match_schema())
        except Exception:
            pass
        templates.append(_TemplateInfo(
            kind=rep.kind, source=src, template=doc, report=rep, crd=crd,
        ))

    mutators: List[Tuple[str, Any]] = []
    for src, doc in mutator_docs:
        try:
            mutators.append((src, mutator_from_obj(doc)))
        except MutatorError:
            continue  # the mutators lint owns spec errors

    providers: Dict[str, bool] = {}
    for _src, doc in provider_docs:
        name = ((doc.get("metadata") or {}).get("name"))
        if not isinstance(name, str) or not name:
            continue
        policy = str(((doc.get("spec") or {}).get("failurePolicy") or ""))
        providers[name] = policy.lower() in (
            "ignore", "open", "fail-open", "",
        )

    return analyze_corpus(
        templates, list(constraint_docs), mutators, providers,
        handler=handler, max_fight_pairs=max_fight_pairs,
    )


def corpus_from_live(
    client: Any,
    mutation_system: Any = None,
    external_data: Any = None,
    max_fight_pairs: int = 256,
) -> CorpusReport:
    """Live entry: the same registries the serving planes hold."""
    templates: List[_TemplateInfo] = []
    handler = None
    with client._lock:
        entries = list(client._templates.values())
        constraint_map = {
            gk: dict(sub) for gk, sub in client._constraints.items()
        }
        for h in client.targets.values():
            handler = h
            break
    for e in entries:
        kind = e.crd.kind
        raw = getattr(e.template, "raw", None)
        templates.append(_TemplateInfo(
            kind=kind,
            source="live",
            # the retained source doc lets the fight pass re-ingest the
            # template into a throwaway interpreter client hermetically
            template=raw if isinstance(raw, dict) and raw else None,
            report=getattr(e.template, "vectorizability", None),
            crd=e.crd,
        ))
    constraints: List[Tuple[str, Dict[str, Any]]] = []
    for _gk, sub in sorted(constraint_map.items()):
        for _subpath, c in sorted(sub.items()):
            constraints.append(("live", c))

    mutators: List[Tuple[str, Any]] = []
    if mutation_system is not None:
        try:
            mutators = [("live", m) for m in mutation_system.ordered()]
        except Exception:
            mutators = []

    providers: Dict[str, bool] = {}
    if external_data is not None:
        try:
            for name in external_data.names():
                p = external_data.get(name)
                providers[name] = bool(getattr(p, "fail_open", True))
        except Exception:
            providers = {}

    return analyze_corpus(
        templates, constraints, mutators, providers,
        handler=handler, max_fight_pairs=max_fight_pairs,
    )


# ---------------------------------------------------------------------------
# serving-side plane


class CorpusPlane:
    """Debounced corpus recompute bound to the live registries.

    The report is recomputed on a background thread when the observed
    churn generation moves — NEVER in the request path. The partition
    planner asks for ``prunable_keys(target, gen)``; the answer is
    only non-empty when the cached report was computed at exactly the
    requested generation (a stale report prunes nothing — missing a
    pruning window is safe, pruning a live constraint is not)."""

    def __init__(
        self,
        client: Any,
        mutation_system: Any = None,
        external_data: Any = None,
        metrics: Any = None,
        debounce_s: float = 1.0,
        clock=None,
    ):
        import time as _time

        self.client = client
        self.mutation_system = mutation_system
        self.external_data = external_data
        self.metrics = metrics
        self.debounce_s = debounce_s
        self.clock = clock or _time.monotonic
        self._lock = threading.Lock()
        self._report: Optional[CorpusReport] = None
        self._computed_gen: Optional[Tuple[int, int]] = None
        self._last_recompute = -float("inf")
        self._pending: Optional[threading.Thread] = None
        self.recomputes = 0

    # -- generation observation ---------------------------------------------

    def _gen(self) -> Tuple[int, int]:
        cgen = 0
        gen_fn = getattr(self.client._driver, "constraint_generation", None)
        if gen_fn is not None:
            try:
                cgen = int(gen_fn())
            except Exception:
                cgen = 0
        mgen = 0
        if self.mutation_system is not None:
            try:
                mgen = int(self.mutation_system.generation)
            except Exception:
                mgen = 0
        return cgen, mgen

    # -- recompute ----------------------------------------------------------

    def refresh(self, force: bool = False) -> CorpusReport:
        """Synchronous recompute (CLI, tests, startup). Debounce does
        not apply; `force` additionally recomputes at an unchanged
        generation."""
        gen = self._gen()
        with self._lock:
            if (
                not force
                and self._report is not None
                and self._computed_gen == gen
            ):
                return self._report
        report = corpus_from_live(
            self.client, self.mutation_system, self.external_data,
        )
        with self._lock:
            self._report = report
            self._computed_gen = gen
            self._last_recompute = self.clock()
            self.recomputes += 1
        self._export(report)
        return report

    def maybe_recompute(self) -> bool:
        """Debounced background recompute when the generation moved;
        True when a recompute thread was started. Cheap enough for the
        planner's miss path — generation compare + time compare."""
        gen = self._gen()
        with self._lock:
            if self._report is not None and self._computed_gen == gen:
                return False
            if self._pending is not None and self._pending.is_alive():
                return False
            if self.clock() - self._last_recompute < self.debounce_s:
                return False
            t = threading.Thread(
                target=self._recompute_bg, name="corpus-analysis",
                daemon=True,
            )
            self._pending = t
        t.start()
        return True

    def _recompute_bg(self) -> None:
        try:
            self.refresh(force=True)
        except Exception:
            pass  # analysis must never take serving down

    def _export(self, report: CorpusReport) -> None:
        if self.metrics is None:
            return
        try:
            counts = report.counts()
            for code in CORPUS_CODES:
                self.metrics.gauge(
                    "corpus_diagnostics_total", counts.get(code, 0),
                    code=code,
                )
        except Exception:
            pass

    # -- planner / readyz feeds ----------------------------------------------

    def prunable_keys(self, target: str, gen: int) -> frozenset:
        """Constraint keys provably safe to exclude from dispatch rows
        at constraint generation `gen`; empty unless the cached report
        was computed at that exact generation (stale = prune nothing).
        `target` is accepted for planner symmetry — keys are already
        the per-target row ids."""
        with self._lock:
            report, cgen = self._report, self._computed_gen
        if report is None or cgen is None or cgen[0] != gen:
            self.maybe_recompute()
            return frozenset()
        return frozenset(report.prunable_keys)

    def shadowed_keys(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._report.shadowed) if self._report else {}

    def report(self) -> Optional[CorpusReport]:
        with self._lock:
            return self._report

    def snapshot(self) -> Dict[str, Any]:
        """/readyz `stats.analysis.corpus` view."""
        gen = self._gen()
        with self._lock:
            report, cgen = self._report, self._computed_gen
            recomputes = self.recomputes
        out: Dict[str, Any] = {
            "computed": report is not None,
            "stale": cgen != gen,
            "recomputes": recomputes,
        }
        if report is not None:
            out.update({
                "ok": report.ok,
                "subjects": report.subjects,
                "counts": report.counts(),
                "dead": len(report.dead_keys),
                "prunable": len(report.prunable_keys),
                "shadowed": len(report.shadowed),
            })
        return out
