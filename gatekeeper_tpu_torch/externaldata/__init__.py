# Copied from gatekeeper_tpu/externaldata/__init__.py; only the docstring's
# program name of the lint's CLI differs.
"""External-data providers: batched, cached, fault-aware out-of-band
lookups (docs/externaldata.md).

The Gatekeeper v3 capability that most stresses the TPU-native design:
admission verdicts depending on facts outside the cluster must consult
them WITHOUT abandoning the fused fast path. The subsystem's layers:

  * `provider.py`   — the externaldata.gatekeeper.sh/v1alpha1 Provider
                      CRD-alike (url/timeout/failurePolicy/TTLs);
  * `cache.py`      — TTL response cache with negative caching and
                      stale-while-revalidate;
  * `system.py`     — the batch plane: one outbound fetch per
                      (provider, micro-batch), per-provider circuit
                      breakers, failurePolicy semantics;
  * `binding.py`    — the process binding the `external_data` Rego
                      builtin resolves through;
  * `extract.py`    — static key extraction feeding batch prefetch;
  * `lint.py`       — GK-P0xx offline provider lint
                      (`python -m gatekeeper_tpu_torch.analysis providers`).
"""

from .binding import get_system, set_system, use_system
from .cache import HIT, MISS, NEGATIVE_HIT, STALE, Entry, ResponseCache
from .provider import (
    EXTERNALDATA_GROUP,
    EXTERNALDATA_VERSION,
    PROVIDER_KIND,
    Provider,
    ProviderError,
    is_provider_doc,
    provider_from_obj,
)
from .system import ExternalDataSystem, HttpFetcher, UnknownProviderError

__all__ = [
    "EXTERNALDATA_GROUP",
    "EXTERNALDATA_VERSION",
    "Entry",
    "ExternalDataSystem",
    "HIT",
    "HttpFetcher",
    "MISS",
    "NEGATIVE_HIT",
    "PROVIDER_KIND",
    "Provider",
    "ProviderError",
    "ResponseCache",
    "STALE",
    "UnknownProviderError",
    "get_system",
    "is_provider_doc",
    "provider_from_obj",
    "set_system",
    "use_system",
]
