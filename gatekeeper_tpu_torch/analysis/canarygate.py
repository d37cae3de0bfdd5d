# Copied from gatekeeper_tpu/analysis/canarygate.py; only this edit
# differs.
# Edit: each template loads into a client over TorchDriver(device="cpu")
# where the reference builds TpuDriver(use_jax=False): the reference's
# gate derives golden verdicts on the host interpreter only, and so does
# this one (the driver's constraints and `_interp_closure`), launching no
# kernel, so a CI job without a card runs it. This is the reference's own
# choice of path, not a fallback: no path of the gate reaches a device.
"""Canary-derivability gate (docs/robustness.md §Verdict integrity).

A template that cannot derive a violating canary is invisible to the
verdict-integrity plane: every golden digest it contributes pins the
EMPTY verdict set, so a device silently suppressing that template's
violations can never trip a canary mismatch. This plane proves, for
every ConstraintTemplate in a policy tree, that
`integrity.canary.synth_reviews` derives at least one review the host
interpreter convicts — the same derivation the live plane performs per
program signature when it builds golden sidecars.

Templates that call `external_data` are NOT skipped: the gate binds an
ExternalDataSystem whose fetcher answers every key with a pinned,
deterministic response (and synthesizes a stub Provider for any
referenced-but-undeclared provider name), so the interpreter pass runs
end-to-end offline. Keys carrying a `:latest` tag — every even-indexed
canary image — answer with an error entry while everything else
resolves cleanly, so error-gated external-data templates convict the
violating canaries and pass the compliant ones. Pinning (rather than
live fetching) is what keeps the derivation deterministic, the same
property live golden sidecars rely on.

GK-I0xx codes (one lint row per template, `analysis canary` / the
`all` gate):

  * GK-I001 — no violating canary derivable (all golden digests would
    pin the empty verdict);
  * GK-I002 — template or constraint rejected at load;
  * GK-I003 — host interpreter error while deriving a golden verdict.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from ..integrity.canary import (
    DEFAULT_K,
    result_digest,
    synth_agent_reviews,
    synth_reviews,
)

__all__ = ["CanaryLint", "PinnedStubFetcher", "canary_lints"]

K8S_TARGET = "admission.k8s.gatekeeper.sh"


class PinnedStubFetcher:
    """Deterministic offline provider responses for the gate's
    interpreter pass: no sockets, same answer on every run."""

    def fetch(self, provider, keys: List[str]
              ) -> Tuple[List[Dict[str, Any]], str]:
        items = []
        for k in keys:
            bad = ":latest" in k or "bad" in k
            items.append(
                {
                    "key": k,
                    "value": "" if bad else f"pinned:{k}",
                    "error": "integrity canary: pinned denial" if bad
                    else "",
                }
            )
        return items, ""


def _stub_provider_obj(name: str) -> Dict[str, Any]:
    """A synthesized Provider CR for a referenced-but-undeclared
    provider name. The URL is never dialed — PinnedStubFetcher answers
    first — but must still parse as reachable."""
    return {
        "apiVersion": "externaldata.gatekeeper.sh/v1alpha1",
        "kind": "Provider",
        "metadata": {"name": name},
        "spec": {"url": "http://integrity-canary.invalid", "timeout": 1},
    }


def _synth_params(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Plausible violating parameters mined from a template's
    openAPIV3Schema, for templates the tree ships no constraint for: a
    required-X string array gets one key no canary carries, an
    allow-list gets one value no canary matches. Best-effort — an
    unrecognised shape synthesizes nothing for that property."""
    schema = (
        (((doc.get("spec") or {}).get("crd") or {}).get("spec") or {})
        .get("validation", {})
        .get("openAPIV3Schema", {})
    )
    props = schema.get("properties") or {}
    params: Dict[str, Any] = {}
    for name, prop in props.items():
        if not isinstance(prop, dict):
            continue
        t = prop.get("type")
        if t == "array":
            items = prop.get("items") or {}
            if items.get("type") == "object":
                entry: Dict[str, Any] = {}
                for k2, p2 in (items.get("properties") or {}).items():
                    if isinstance(p2, dict) and p2.get("type") == "string":
                        entry[k2] = (
                            "" if "regex" in k2.lower()
                            else "integrity-canary/required"
                        )
                params[name] = [entry or {"key": "integrity-canary/required"}]
            else:
                params[name] = ["integrity-canary.invalid/"]
        elif t == "string":
            params[name] = "integrity-canary"
        elif t in ("integer", "number"):
            params[name] = 1
        elif t == "boolean":
            params[name] = True
    return params


def _default_constraint(
    kind: str, doc: Dict[str, Any], agent: bool
) -> Dict[str, Any]:
    """A synthesized constraint for a template the policy tree ships
    without one — the canary set still has to derive. The admission
    target's match is omitted entirely (an absent kind selector
    defaults to wildcard, so both canary object shapes match without
    naming any target-specific vocabulary here); the agent target
    matches every tool. Parameters are schema-mined."""
    from ..constraint.templates import CONSTRAINT_API_VERSION

    spec: Dict[str, Any] = {"match": {"tools": ["*"]}} if agent else {}
    params = _synth_params(doc)
    if params:
        spec["parameters"] = params
    return {
        "apiVersion": CONSTRAINT_API_VERSION,
        "kind": kind,
        "metadata": {"name": f"integrity-canary-{kind.lower()}"},
        "spec": spec,
    }


@dataclass
class CanaryLint:
    """One template's derivability row (the shared code-lint shape:
    `id`/`codes`/`ok`/`render`/`to_dict`, so the canary plane rides the
    same baseline/report plumbing as every other subcommand)."""

    id: str
    source: str
    codes: List[str] = field(default_factory=list)
    messages: List[str] = field(default_factory=list)
    canaries: int = 0
    violating: int = 0
    external_data: bool = False
    providers: List[str] = field(default_factory=list)
    digests: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.codes

    def render(self) -> str:
        head = (
            f"{self.id}: canaries={self.canaries} "
            f"violating={self.violating}"
            + (" external_data(stubbed)" if self.external_data else "")
        )
        if self.ok:
            return f"{head} OK"
        probs = "; ".join(
            f"{c}: {m}" for c, m in zip(self.codes, self.messages)
        )
        return f"{head} {probs}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "template": self.id,
            "source": self.source,
            "codes": list(self.codes),
            "messages": list(self.messages),
            "canaries": self.canaries,
            "violating": self.violating,
            "external_data": self.external_data,
            "providers": list(self.providers),
            "digests": list(self.digests),
        }


def canary_lints(
    template_docs: List[Tuple[str, Dict[str, Any]]],
    constraint_docs: List[Tuple[str, Dict[str, Any]]],
    provider_docs: List[Tuple[str, Dict[str, Any]]],
    k: int = DEFAULT_K,
) -> List[CanaryLint]:
    """One CanaryLint per template: load it (alone) into a host-only
    client with the tree's constraints of its kind, derive the canary
    set, and replay it through the host interpreter — the golden
    derivation path. A template is clean when at least one canary
    convicts. The driver is TorchDriver on the CPU: the derivation
    reads its constraints and its interpreter closure only, so no
    kernel is built or launched and a host without a card runs the
    gate."""
    from ..constraint import Backend, K8sValidationTarget
    from ..constraint.torchdriver import TorchDriver
    from ..externaldata import ExternalDataSystem, ProviderError
    from .analyzer import analyze_template

    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for _src, c in constraint_docs:
        by_kind.setdefault(str(c.get("kind") or ""), []).append(c)

    lints: List[CanaryLint] = []
    for src, doc in template_docs:
        kind = str(
            (((doc.get("spec") or {}).get("crd") or {}).get("spec") or {})
            .get("names", {})
            .get("kind")
            or (doc.get("metadata") or {}).get("name")
            or src
        )
        lint = CanaryLint(id=kind, source=src)
        lints.append(lint)

        rep = analyze_template(doc)
        referenced = sorted(
            {c.provider for c in rep.external_calls if c.provider}
        )
        lint.external_data = bool(rep.external_calls)
        lint.providers = referenced

        targets = (doc.get("spec") or {}).get("targets") or []
        tgt_name = str(
            (targets[0] or {}).get("target") if targets else ""
        ) or K8S_TARGET
        agent = tgt_name == "agent.action.gatekeeper.sh"
        if agent:
            from ..agentaction import AgentActionTarget

            tgt = AgentActionTarget()
        else:
            tgt = K8sValidationTarget()

        drv = TorchDriver(device="cpu")
        cl = Backend(drv).new_client(tgt)
        if lint.external_data:
            system = ExternalDataSystem(fetcher=PinnedStubFetcher())
            declared = set()
            for _psrc, pobj in provider_docs:
                try:
                    declared.add(system.upsert(pobj).name)
                except ProviderError:
                    continue  # the providers lint plane owns spec bugs
            for name in referenced:
                if name not in declared:
                    system.upsert(_stub_provider_obj(name))
            cl.set_external_data(system)

        try:
            cl.add_template(doc)
            cons = by_kind.get(kind) or [
                _default_constraint(kind, doc, agent)
            ]
            for c in cons:
                cl.add_constraint(c)
        except Exception as e:
            lint.codes.append("GK-I002")
            lint.messages.append(f"template/constraint rejected: {e}")
            continue

        constraints = drv._constraints(tgt_name)
        reviews = (
            synth_agent_reviews(constraints, k=k)
            if agent
            else synth_reviews(constraints, k=k)
        )
        closure = drv._interp_closure(tgt_name, constraints)
        lint.canaries = len(reviews)
        derived = True
        for review in reviews:
            try:
                results = closure(review)
            except Exception as e:
                lint.codes.append("GK-I003")
                lint.messages.append(
                    f"interpreter error deriving golden verdict: {e}"
                )
                derived = False
                break
            lint.digests.append(result_digest(results))
            if results:
                lint.violating += 1
        if derived and lint.violating == 0:
            lint.codes.append("GK-I001")
            lint.messages.append(
                "no violating canary derivable: every golden digest "
                "would pin the empty verdict set, so device corruption "
                "suppressing this template's violations is undetectable"
            )
    return lints
