# Copied from gatekeeper_tpu/externaldata/provider.py; unchanged.
"""Provider model: the `externaldata.gatekeeper.sh/v1alpha1` CRD-alike.

Gatekeeper v3's external-data Provider names an out-of-cluster HTTP
endpoint that answers key lookups (image signatures, CMDB records,
allowlists). The TPU build keeps the upstream spec surface (url,
timeout, caBundle) and adds the caching/failure knobs the batch plane
needs: per-provider response TTLs (positive, negative,
stale-while-revalidate) and an explicit failurePolicy that decides what
an *unreachable* provider means for admission — fail-open (lookups
resolve empty, error-gated templates allow) or fail-closed (lookups
resolve to per-key errors, error-gated templates deny).

The wire protocol mirrors upstream's ProviderRequest/ProviderResponse:

    POST <url>
    {"apiVersion": "externaldata.gatekeeper.sh/v1alpha1",
     "kind": "ProviderRequest", "request": {"keys": [...]}}

    {"apiVersion": "externaldata.gatekeeper.sh/v1alpha1",
     "kind": "ProviderResponse",
     "response": {"items": [{"key": ..., "value": ..., "error": ...}],
                  "systemError": ""}}
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

EXTERNALDATA_GROUP = "externaldata.gatekeeper.sh"
EXTERNALDATA_VERSION = "v1alpha1"
PROVIDER_KIND = "Provider"

FAIL_OPEN = "open"
FAIL_CLOSED = "closed"

# accepted spellings -> canonical policy (upstream webhook vocabulary
# plus the explicit forms docs/externaldata.md documents)
_POLICY_ALIASES = {
    "ignore": FAIL_OPEN,
    "fail": FAIL_CLOSED,
    "open": FAIL_OPEN,
    "closed": FAIL_CLOSED,
    "fail-open": FAIL_OPEN,
    "fail-closed": FAIL_CLOSED,
}

DEFAULT_TIMEOUT_S = 3.0
DEFAULT_CACHE_TTL_S = 30.0
DEFAULT_NEGATIVE_TTL_S = 5.0
DEFAULT_STALE_TTL_S = 0.0
DEFAULT_MAX_KEYS = 512


class ProviderError(ValueError):
    """Invalid Provider spec (ingest-time rejection; the controller
    surfaces it on the ProviderPodStatus CR instead of crashing)."""


@dataclass
class Provider:
    """One validated provider. Timeouts/TTLs are seconds."""

    name: str
    url: str
    timeout_s: float = DEFAULT_TIMEOUT_S
    failure_policy: str = FAIL_OPEN
    cache_ttl_s: float = DEFAULT_CACHE_TTL_S
    negative_ttl_s: float = DEFAULT_NEGATIVE_TTL_S
    stale_ttl_s: float = DEFAULT_STALE_TTL_S
    max_keys: int = DEFAULT_MAX_KEYS
    ca_bundle: Optional[str] = None
    raw: Dict[str, Any] = field(default_factory=dict)

    @property
    def fail_open(self) -> bool:
        return self.failure_policy == FAIL_OPEN


def _num(spec: Dict[str, Any], key: str, default: float) -> float:
    v = spec.get(key, default)
    if v is None:
        return default
    try:
        out = float(v)
    except (TypeError, ValueError):
        raise ProviderError(f"spec.{key} must be a number, got {v!r}")
    if out < 0:
        raise ProviderError(f"spec.{key} must be >= 0, got {v!r}")
    return out


def provider_from_obj(obj: Dict[str, Any]) -> Provider:
    """Parse + validate a Provider CR dict. Raises ProviderError on any
    spec problem (the GK-P lint codes in lint.py key off these
    messages)."""
    if not isinstance(obj, dict):
        raise ProviderError("provider must be an object")
    api = str(obj.get("apiVersion", ""))
    if api and not api.startswith(EXTERNALDATA_GROUP):
        raise ProviderError(
            f"apiVersion must be in group {EXTERNALDATA_GROUP}, got {api!r}"
        )
    if obj.get("kind") not in (None, PROVIDER_KIND):
        raise ProviderError(f"kind must be {PROVIDER_KIND}")
    name = ((obj.get("metadata") or {}).get("name")) or ""
    if not name:
        raise ProviderError("provider has no metadata.name")
    spec = obj.get("spec") or {}
    if not isinstance(spec, dict):
        raise ProviderError("spec must be an object")
    url = spec.get("url")
    if not isinstance(url, str) or not url:
        raise ProviderError("spec.url is required")
    scheme = url.split("://", 1)[0].lower() if "://" in url else ""
    if scheme not in ("http", "https"):
        raise ProviderError(
            f"spec.url scheme {scheme or '<none>'!r} is unreachable "
            "(want http or https)"
        )
    raw_policy = str(spec.get("failurePolicy", "Ignore")).lower()
    policy = _POLICY_ALIASES.get(raw_policy)
    if policy is None:
        raise ProviderError(
            f"spec.failurePolicy {spec.get('failurePolicy')!r} is not one "
            "of Ignore|Fail|fail-open|fail-closed"
        )
    timeout_s = _num(spec, "timeout", DEFAULT_TIMEOUT_S)
    if timeout_s == 0:
        raise ProviderError("spec.timeout must be > 0 seconds")
    max_keys = int(_num(spec, "maxKeysPerRequest", DEFAULT_MAX_KEYS))
    if max_keys < 1:
        raise ProviderError("spec.maxKeysPerRequest must be >= 1")
    return Provider(
        name=name,
        url=url,
        timeout_s=timeout_s,
        failure_policy=policy,
        cache_ttl_s=_num(spec, "cacheTTLSeconds", DEFAULT_CACHE_TTL_S),
        negative_ttl_s=_num(
            spec, "negativeCacheTTLSeconds", DEFAULT_NEGATIVE_TTL_S
        ),
        stale_ttl_s=_num(
            spec, "staleWhileRevalidateSeconds", DEFAULT_STALE_TTL_S
        ),
        max_keys=max_keys,
        ca_bundle=spec.get("caBundle"),
        raw=obj,
    )


def is_provider_doc(doc: Any) -> bool:
    return (
        isinstance(doc, dict)
        and doc.get("kind") == PROVIDER_KIND
        and str(doc.get("apiVersion", "")).startswith(EXTERNALDATA_GROUP)
    )
