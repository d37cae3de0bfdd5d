# Copied from gatekeeper_tpu/externaldata/lint.py; unchanged.
"""Offline provider diagnostics with stable GK-P0xx codes.

Shared by the analysis CLI's `providers` mode and CI (mirrors the
mutator linter's GK-M0xx contract — docs/externaldata.md documents the
codes):

  GK-P001  unreachable URL scheme (not http/https) or missing URL
  GK-P002  missing/zero timeout (a provider without a deadline can
           stall the batch fetch to the webhook's own deadline)
  GK-P003  fail-open without a cache (cacheTTLSeconds=0): every outage
           silently allows with no stale fallback — pair fail-open with
           a TTL or accept blind spots explicitly
  GK-P004  invalid failurePolicy value
  GK-P005  stale-while-revalidate window without a positive TTL
  GK-P006  spec parse error (bad types, missing name)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from .provider import ProviderError, provider_from_obj


@dataclass
class ProviderLint:
    """One provider's lint outcome."""

    id: str
    source: str = ""
    codes: List[str] = field(default_factory=list)
    messages: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.codes

    def add(self, code: str, message: str) -> None:
        if code not in self.codes:
            self.codes.append(code)
        self.messages.append(f"{code}: {message}")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "source": self.source,
            "codes": list(self.codes),
            "messages": list(self.messages),
            "ok": self.ok,
        }

    def render(self) -> str:
        if self.ok:
            return f"{self.id}: OK"
        return f"{self.id}: " + "; ".join(self.messages)


def _classify_error(err: ProviderError) -> str:
    msg = str(err)
    if "scheme" in msg or "spec.url" in msg:
        return "GK-P001"
    if "timeout" in msg:
        return "GK-P002"
    if "failurePolicy" in msg:
        return "GK-P004"
    return "GK-P006"


def lint_providers(
    docs: List[Tuple[str, Dict[str, Any]]],
) -> List[ProviderLint]:
    """[(source, provider dict)] -> per-provider lint results. Parse
    errors carry their classified code; valid providers are additionally
    checked for the operational footguns (GK-P002/3/5)."""
    out: List[ProviderLint] = []
    for source, doc in docs:
        name = (
            ((doc.get("metadata") or {}).get("name") or "?")
            if isinstance(doc, dict)
            else "?"
        )
        lint = ProviderLint(id=f"Provider/{name}", source=source)
        out.append(lint)
        try:
            p = provider_from_obj(doc)
        except ProviderError as e:
            lint.add(_classify_error(e), str(e))
            continue
        spec = (doc.get("spec") or {})
        if "timeout" not in spec:
            lint.add(
                "GK-P002",
                "no spec.timeout: the default applies, but an explicit "
                "deadline is required for reviewable provider rollouts",
            )
        if p.fail_open and p.cache_ttl_s <= 0:
            lint.add(
                "GK-P003",
                "failurePolicy fail-open with cacheTTLSeconds=0: every "
                "provider outage is a silent allow with no cached or "
                "stale fallback",
            )
        if p.stale_ttl_s > 0 and p.cache_ttl_s <= 0:
            lint.add(
                "GK-P005",
                "staleWhileRevalidateSeconds without a positive "
                "cacheTTLSeconds never serves stale (nothing is ever "
                "cached to go stale)",
            )
    return out
