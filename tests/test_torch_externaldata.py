"""The port's external-data plane (gatekeeper_tpu_torch/externaldata) on
the CPU.

The host-only cases of tests/test_externaldata.py run against the port's
copies (provider parse and rejections, cache windows, one fetch per epoch,
failure policies, the breaker, fault points, the interpreter end to end,
the analyzer's call records, lint). Then the fused path: one seeded stub
provider feeds both packages' ExternalDataSystems, and TorchDriver
(device="cpu") is held against the JAX package's TpuDriver on the same
pods: the "extdata:" row bits row by row in "err" and "all" modes, the
fetch counts, audit() and review_many() results (exact equality, same
order), a cache-hit batch that stays fused, and a TTL expiry that routes
rows back to the interpreter's re-check.
"""

import threading
import time

import numpy as np
import pytest

import chip_smoke
from gatekeeper_tpu.constraint import (
    AugmentedReview as JAugReview,
    AugmentedUnstructured as JAug,
    Backend as JBackend,
    K8sValidationTarget as JTarget,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu.externaldata import (
    ExternalDataSystem as JExternalDataSystem,
    set_system as j_set_system,
)
from gatekeeper_tpu_torch.constraint import (
    AugmentedReview,
    AugmentedUnstructured,
    Backend,
    K8sValidationTarget,
)
from gatekeeper_tpu_torch.constraint.driver import RegoDriver
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.externaldata import (
    ExternalDataSystem,
    Provider,
    ProviderError,
    ResponseCache,
    provider_from_obj,
)
from gatekeeper_tpu_torch.externaldata.cache import HIT, MISS, NEGATIVE_HIT, STALE
from gatekeeper_tpu_torch.externaldata.lint import lint_providers
from gatekeeper_tpu_torch.faults import FAULTS

TARGET = "admission.k8s.gatekeeper.sh"

EXTERNAL_REGO = """
package k8sexternal
violation[{"msg": msg}] {
  images := [img | img := input.review.object.spec.containers[_].image]
  response := external_data({"provider": "stub-provider", "keys": images})
  count(response.errors) > 0
  msg := sprintf("image verification failed: %v", [response.errors])
}
"""

# value-dependent (the analyzer's "all" mode): every matching row re-checks
VALUE_REGO = """
package k8sexternalvalue
violation[{"msg": msg}] {
  images := [img | img := input.review.object.spec.containers[_].image]
  response := external_data({"provider": "stub-provider", "keys": images})
  response.responses[_][1] == "deny"
  msg := "value-gated"
}
"""


def external_template(rego=EXTERNAL_REGO, kind="K8sExternal"):
    return {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": kind.lower()},
        "spec": {
            "crd": {"spec": {"names": {"kind": kind}}},
            "targets": [{"target": TARGET, "rego": rego}],
        },
    }


def external_constraint(kind="K8sExternal", name="verify-images"):
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind,
        "metadata": {"name": name},
        "spec": {
            "match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}
        },
    }


def pod_request(name, image):
    return {
        "uid": name,
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "operation": "CREATE",
        "name": name,
        "namespace": "default",
        "userInfo": {"username": "test"},
        "object": {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{"name": "c", "image": image}]},
        },
    }


def make_client(system, driver=None):
    client = Backend(driver or RegoDriver()).new_client(
        K8sValidationTarget()
    )
    client.set_external_data(system)
    client.add_template(external_template())
    client.add_constraint(external_constraint())
    return client


@pytest.fixture(autouse=True)
def _unbind_system():
    yield
    from gatekeeper_tpu_torch.externaldata import set_system

    set_system(None)
    j_set_system(None)
    FAULTS.reset()


# -- provider spec -----------------------------------------------------------


def test_provider_parse_and_defaults(stub_provider):
    p = provider_from_obj(stub_provider.provider_obj())
    assert p.name == "stub-provider"
    assert p.fail_open
    assert p.cache_ttl_s == 300

    closed = provider_from_obj(
        stub_provider.provider_obj(failurePolicy="Fail")
    )
    assert not closed.fail_open


@pytest.mark.parametrize(
    "spec, needle",
    [
        ({"url": "ftp://x"}, "scheme"),
        ({"url": ""}, "url"),
        ({"url": "http://x", "timeout": 0}, "timeout"),
        ({"url": "http://x", "failurePolicy": "Maybe"}, "failurePolicy"),
        ({"url": "http://x", "cacheTTLSeconds": -1}, "cacheTTLSeconds"),
    ],
)
def test_provider_spec_rejections(spec, needle):
    with pytest.raises(ProviderError, match=needle):
        provider_from_obj(
            {
                "apiVersion": "externaldata.gatekeeper.sh/v1alpha1",
                "kind": "Provider",
                "metadata": {"name": "p"},
                "spec": spec,
            }
        )


# -- cache semantics ---------------------------------------------------------


def test_cache_ttl_negative_and_stale_windows():
    now = [100.0]
    cache = ResponseCache(clock=lambda: now[0])
    cache.put("p", "k", value="v", ttl=10, stale_ttl=20)
    cache.put("p", "bad", error="nope", ttl=5)

    st = cache.classify("p", ["k", "bad", "missing"])
    assert st["k"][0] == HIT
    assert st["bad"][0] == NEGATIVE_HIT
    assert st["missing"][0] == MISS

    now[0] = 112.0  # past ttl, inside stale window; negative expired
    st = cache.classify("p", ["k", "bad"])
    assert st["k"][0] == STALE
    assert st["bad"][0] == MISS

    now[0] = 131.0  # past stale window
    assert cache.classify("p", ["k"])["k"][0] == MISS


def test_cache_drop_provider_isolates():
    cache = ResponseCache()
    cache.put("a", "k", value=1, ttl=100)
    cache.put("b", "k", value=2, ttl=100)
    cache.drop_provider("a")
    assert cache.classify("a", ["k"])["k"][0] == MISS
    assert cache.classify("b", ["k"])["k"][0] == HIT


# -- system: dedup / one fetch per batch -------------------------------------


def test_prefetch_dedupes_to_one_fetch(stub_provider):
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj())
    system.begin_batch()
    system.prefetch({"stub-provider": {"a", "b", "a", "c"}})
    assert stub_provider.fetch_count == 1
    assert sorted(stub_provider.requests[0]) == ["a", "b", "c"]
    # repeat keys: no new fetch
    system.begin_batch()
    system.prefetch({"stub-provider": {"a", "b"}})
    assert stub_provider.fetch_count == 1


def test_resolve_serves_values_and_errors(stub_provider):
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj())
    resp = system.resolve("stub-provider", ["good", "bad-img"])
    assert resp["status_code"] == 200
    assert ["good", "ok:good"] in resp["responses"]
    assert ["bad-img", "unsigned"] in resp["errors"]
    # second resolve: pure cache, no new fetch (negative cached too)
    n = stub_provider.fetch_count
    resp2 = system.resolve("stub-provider", ["good", "bad-img"])
    assert resp2["errors"] == resp["errors"]
    assert stub_provider.fetch_count == n


def test_failed_fetch_not_retried_within_epoch(stub_provider):
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj())
    stub_provider.fail = True
    system.begin_batch()
    system.prefetch({"stub-provider": {"x"}})
    assert stub_provider.fetch_count == 1
    # resolutions in the same epoch must not refetch
    r = system.resolve("stub-provider", ["x"])
    assert r["status_code"] == 500 and r["system_error"]
    assert stub_provider.fetch_count == 1
    # the next batch retries exactly once
    system.begin_batch()
    system.prefetch({"stub-provider": {"x"}})
    assert stub_provider.fetch_count == 2


def test_stale_while_revalidate_serves_then_refreshes(stub_provider):
    now = [0.0]
    system = ExternalDataSystem(clock=lambda: now[0])
    system.upsert(
        stub_provider.provider_obj(
            cacheTTLSeconds=10, staleWhileRevalidateSeconds=100
        )
    )
    system.resolve("stub-provider", ["k"])
    assert stub_provider.fetch_count == 1
    now[0] = 50.0  # expired, inside the stale window
    resp = system.resolve("stub-provider", ["k"])
    assert ["k", "ok:k"] in resp["responses"]
    assert resp["status_code"] == 200
    assert system.stale_serves >= 1
    # the background revalidation lands as one fetch
    deadline = time.monotonic() + 2
    while stub_provider.fetch_count < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert stub_provider.fetch_count == 2


# -- failure policy ----------------------------------------------------------


def test_fail_open_outage_resolves_empty(stub_provider):
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj(failurePolicy="Ignore"))
    stub_provider.fail = True
    resp = system.resolve("stub-provider", ["k"])
    assert resp["errors"] == []
    assert resp["responses"] == []
    assert resp["status_code"] == 500 and resp["system_error"]


def test_fail_closed_outage_resolves_per_key_errors(stub_provider):
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj(failurePolicy="Fail"))
    stub_provider.fail = True
    resp = system.resolve("stub-provider", ["k1", "k2"])
    assert len(resp["errors"]) == 2
    assert all("fail-closed" in e[1] for e in resp["errors"])


def test_breaker_trips_and_recovers_per_provider(stub_provider):
    now = [0.0]
    system = ExternalDataSystem(
        clock=lambda: now[0], breaker_recovery_s=30.0
    )
    system.upsert(stub_provider.provider_obj(cacheTTLSeconds=0))
    stub_provider.fail = True
    for i in range(3):
        system.begin_batch()
        system.prefetch({"stub-provider": {f"k{i}"}})
    br = system.breaker("stub-provider")
    assert br.state == "open"
    # open breaker: no outbound calls at all
    n = stub_provider.fetch_count
    system.begin_batch()
    system.prefetch({"stub-provider": {"k9"}})
    assert stub_provider.fetch_count == n
    # recovery: half-open probe succeeds and closes
    stub_provider.fail = False
    now[0] = 31.0
    system.begin_batch()
    system.prefetch({"stub-provider": {"k9"}})
    assert stub_provider.fetch_count == n + 1
    assert br.state == "closed"


def test_breaker_open_fail_open_endpoint_still_allows(stub_provider):
    """Acceptance: breaker-open providers degrade per failurePolicy —
    a fail-open endpoint keeps admitting, never 500s."""
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj(cacheTTLSeconds=0))
    stub_provider.fail = True
    client = make_client(system)
    for i in range(4):  # trips the breaker along the way
        r = client.review(AugmentedReview(pod_request(f"p{i}", "nginx")))
        assert r.by_target[TARGET].results == []
    assert system.breaker("stub-provider").state == "open"


def test_breaker_open_fail_closed_denies_with_provider_message(
    stub_provider,
):
    system = ExternalDataSystem()
    system.upsert(
        stub_provider.provider_obj(
            failurePolicy="Fail", cacheTTLSeconds=0
        )
    )
    stub_provider.fail = True
    client = make_client(system)
    for i in range(4):
        r = client.review(AugmentedReview(pod_request(f"p{i}", "nginx")))
        results = r.by_target[TARGET].results
        assert len(results) == 1
        assert "stub-provider" in results[0].msg
        assert "fail-closed" in results[0].msg


# -- fault injection ---------------------------------------------------------


def test_externaldata_fetch_fault_point(stub_provider):
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj(failurePolicy="Fail"))
    FAULTS.arm("externaldata.fetch", mode="error", count=1)
    resp = system.resolve("stub-provider", ["k"])
    assert resp["errors"] and stub_provider.fetch_count == 0
    # the injected failure burned the epoch; next batch fetches fine
    system.begin_batch()
    resp = system.resolve("stub-provider", ["k"])
    assert resp["errors"] == [] and stub_provider.fetch_count == 1


def test_externaldata_cache_passive_probe(stub_provider):
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj())
    FAULTS.arm("externaldata.cache", mode="error", count=0)  # passive
    system.resolve("stub-provider", ["k"])
    assert FAULTS.hits("externaldata.cache") >= 1


# -- interpreter evaluation (RegoDriver end to end) --------------------------


def test_interpreter_end_to_end(stub_provider):
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj())
    client = make_client(system)
    ok = client.review(AugmentedReview(pod_request("good", "nginx:1")))
    assert ok.by_target[TARGET].results == []
    bad = client.review(
        AugmentedReview(pod_request("evil", "bad.example/img"))
    )
    msgs = [r.msg for r in bad.by_target[TARGET].results]
    assert msgs and "unsigned" in msgs[0]


def test_unknown_provider_is_undefined_not_denied(stub_provider):
    system = ExternalDataSystem()  # no providers registered
    client = make_client(system)
    r = client.review(AugmentedReview(pod_request("p", "nginx")))
    assert r.by_target[TARGET].results == []


def test_no_system_bound_is_undefined():
    from gatekeeper_tpu_torch.externaldata import set_system

    client = make_client(None)
    set_system(None)
    r = client.review(AugmentedReview(pod_request("p", "nginx")))
    assert r.by_target[TARGET].results == []


# -- analyzer ----------------------------------------------------------------


def test_analyzer_records_error_gated_extractable_call():
    from gatekeeper_tpu_torch.analysis import analyze_template

    rep = analyze_template(external_template())
    assert rep.verdict == "PARTIAL_ROWS"
    assert "GK-V009" in rep.codes
    assert rep.extdata_mode() == "err"
    assert rep.external_providers() == ["stub-provider"]
    [call] = rep.external_calls
    assert call.extractable and call.error_gated


def test_analyzer_value_dependent_call_is_all_mode():
    rego = """
package k8sexternal
violation[{"msg": msg}] {
  images := [img | img := input.review.object.spec.containers[_].image]
  response := external_data({"provider": "stub-provider", "keys": images})
  response.responses[_][1] == "deny"
  msg := "value-gated"
}
"""
    from gatekeeper_tpu_torch.analysis import analyze_template

    rep = analyze_template(external_template(rego=rego))
    assert rep.extdata_mode() == "all"
    [call] = rep.external_calls
    assert call.extractable and not call.error_gated


def test_analyzer_nonliteral_provider_not_extractable():
    rego = """
package k8sexternal
violation[{"msg": msg}] {
  p := input.parameters.provider
  response := external_data({"provider": p, "keys": ["x"]})
  count(response.errors) > 0
  msg := "x"
}
"""
    from gatekeeper_tpu_torch.analysis import analyze_template

    rep = analyze_template(external_template(rego=rego))
    assert rep.extdata_mode() is None
    [call] = rep.external_calls
    assert not call.extractable


# -- lint (GK-P0xx) ----------------------------------------------------------


def test_provider_lint_codes():
    def doc(name, spec):
        return (
            "t.yaml",
            {
                "apiVersion": "externaldata.gatekeeper.sh/v1alpha1",
                "kind": "Provider",
                "metadata": {"name": name},
                "spec": spec,
            },
        )

    lints = {
        lint.id: lint
        for lint in lint_providers(
            [
                doc("scheme", {"url": "ftp://x", "timeout": 1}),
                doc("no-timeout", {"url": "http://x"}),
                doc(
                    "blind-open",
                    {
                        "url": "http://x",
                        "timeout": 1,
                        "failurePolicy": "Ignore",
                        "cacheTTLSeconds": 0,
                    },
                ),
                doc(
                    "bad-policy",
                    {"url": "http://x", "timeout": 1,
                     "failurePolicy": "Maybe"},
                ),
                doc(
                    "stale-no-ttl",
                    {
                        "url": "http://x",
                        "timeout": 1,
                        "cacheTTLSeconds": 0,
                        "staleWhileRevalidateSeconds": 60,
                    },
                ),
                doc(
                    "clean",
                    {"url": "https://x", "timeout": 1,
                     "cacheTTLSeconds": 30},
                ),
            ]
        )
    }
    assert lints["Provider/scheme"].codes == ["GK-P001"]
    assert lints["Provider/no-timeout"].codes == ["GK-P002"]
    assert "GK-P003" in lints["Provider/blind-open"].codes
    assert lints["Provider/bad-policy"].codes == ["GK-P004"]
    assert "GK-P005" in lints["Provider/stale-no-ttl"].codes
    assert lints["Provider/clean"].ok


# -- concurrency -------------------------------------------------------------


def test_concurrent_resolves_share_one_fetch(stub_provider):
    """Many threads resolving the same cold key: the epoch/breaker
    plumbing must not multiply outbound fetches unboundedly (the cache
    write races are benign — same value)."""
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj())
    system.resolve("stub-provider", ["warm"])  # registry warm
    stub_provider.requests.clear()

    errs = []

    def one(i):
        try:
            r = system.resolve("stub-provider", ["shared-key"])
            assert ["shared-key", "ok:shared-key"] in r["responses"]
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    # racing cold resolves may each fetch once, but the steady state
    # must converge: a fresh wave after the cache is warm fetches zero
    n = stub_provider.fetch_count
    assert n >= 1
    for _ in range(8):
        system.resolve("stub-provider", ["shared-key"])
    assert stub_provider.fetch_count == n


# -- the three refusals are gone ---------------------------------------------


def test_extdata_template_compiles_with_its_row_feature(stub_provider):
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj())
    drv = TorchDriver(device="cpu")
    client = make_client(system, driver=drv)
    assert drv.external_data is system
    client.add_data(pod_request("p0", "nginx:1")["object"])
    client.audit()
    [prog] = drv._cset[TARGET].programs
    assert prog is not None
    assert "extdata:K8sExternal:err" in prog.row_features


# -- parity with the JAX package on the fused path ---------------------------

N_IMAGES = 40
N_PODS = 96


def _catalogue(seed=7):
    rng = np.random.default_rng(seed)
    images = [f"registry.example/app{i}:v{i % 5}" for i in range(N_IMAGES)]
    flagged = {images[i] for i in rng.choice(N_IMAGES, 4, replace=False)}
    return images, flagged, rng


def _pods(images, rng, n=N_PODS, prefix="pod"):
    out = []
    for i in range(n):
        k = int(rng.integers(1, 4))
        out.append({
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {"name": f"{prefix}-{i}", "namespace": "default"},
            "spec": {"containers": [
                {"name": f"c{j}", "image": images[int(rng.integers(N_IMAGES))]}
                for j in range(k)
            ]},
        })
    return out


def _keys(results):
    return [chip_smoke.result_key(r) for r in results]


def _pair(stub, templates, clock=None, **spec):
    """One TorchDriver client and one TpuDriver client over the same
    templates and pods, each with its own ExternalDataSystem fed by the
    same stub provider."""
    kw = {} if clock is None else {"clock": clock}
    t_sys, j_sys = ExternalDataSystem(**kw), JExternalDataSystem(**kw)
    t_drv, j_drv = TorchDriver(device="cpu"), TpuDriver()
    out = {}
    for name, backend, target, drv, sys_ in (
        ("torch", Backend, K8sValidationTarget, t_drv, t_sys),
        ("tpu", JBackend, JTarget, j_drv, j_sys),
    ):
        sys_.upsert(stub.provider_obj(**spec))
        client = backend(drv).new_client(target())
        client.set_external_data(sys_)
        for rego, kind in templates:
            client.add_template(external_template(rego, kind))
            client.add_constraint(external_constraint(kind, kind.lower()))
        out[name] = (client, drv, sys_)
    return out


@pytest.fixture
def flagged_stub(stub_provider):
    images, flagged, rng = _catalogue()
    stub_provider.responder = lambda key: (
        {"key": key, "error": "unsigned"} if key in flagged
        else {"key": key, "value": "deny" if key.endswith(":v3") else "ok"}
    )
    return stub_provider, images, flagged, rng


@pytest.mark.parametrize("rego, kind, mode", [
    (EXTERNAL_REGO, "K8sExternal", "err"),
    (VALUE_REGO, "K8sExternalValue", "all"),
])
def test_row_bits_fetches_and_audit_equal_jax(flagged_stub, rego, kind, mode):
    stub, images, flagged, rng = flagged_stub
    pods = _pods(images, rng)
    pair = _pair(stub, [(rego, kind)])
    got = {}
    for name, (client, drv, sys_) in pair.items():
        for p in pods:
            client.add_data(p)
        res = client.audit().by_target[TARGET].results
        corpus = drv._corpus[TARGET]
        bits = drv._extdata_row_bits(TARGET, corpus, f"extdata:{kind}:{mode}")
        got[name] = (_keys(res), np.asarray(bits).tolist(), sys_.fetch_count,
                     [str(r["metadata"]["name"]) for r in
                      (x["object"] for x in corpus.reviews)])
    assert got["torch"] == got["tpu"]
    res, bits, fetches, _ = got["torch"]
    # one outbound fetch per sweep, covering every distinct image
    assert fetches == 1
    if mode == "err":
        want = [any(c["image"] in flagged for c in p["spec"]["containers"])
                for p in pods]
        assert sorted(bits) == sorted(want) and sum(bits) > 0
        assert len(res) == sum(want)
    else:
        assert all(bits)
        assert len(res) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_review_many_and_fetches_equal_jax(flagged_stub, seed):
    stub, images, flagged, _ = flagged_stub
    pair = _pair(stub, [(EXTERNAL_REGO, "K8sExternal")])
    rng = np.random.default_rng(100 + seed)
    batches = [_pods(images, rng, n=24, prefix=f"b{seed}-{b}")
               for b in range(3)]
    got = {}
    for name, (client, drv, sys_) in pair.items():
        aug = AugmentedUnstructured if name == "torch" else JAug
        if name == "tpu":
            assert client.warm_review_path([aug(p) for p in batches[0]])
        n0 = sys_.fetch_count
        seen = []
        for b in batches:
            out = client.review_many([aug(p) for p in b])
            seen.append(([_keys(r.by_target[TARGET].results) for r in out],
                         sys_.fetch_count - n0))
        got[name] = seen
    assert got["torch"] == got["tpu"]
    # at most one outbound fetch per micro-batch
    assert all(0 <= f - (got["torch"][i - 1][1] if i else 0) <= 1
               for i, (_, f) in enumerate(got["torch"]))
    assert sum(len(k) for b, _ in got["torch"] for k in b) > 0


def test_cache_hit_batch_stays_fused(flagged_stub):
    stub, images, flagged, _ = flagged_stub
    clean = [i for i in images if i not in flagged]
    pair = _pair(stub, [(EXTERNAL_REGO, "K8sExternal")])
    for name, (client, drv, sys_) in pair.items():
        aug = AugmentedUnstructured if name == "torch" else JAug
        seed = [aug(pod_request(f"s{i}", img)["object"])
                for i, img in enumerate(clean[:24])]
        if name == "tpu":
            assert client.warm_review_path(seed)
        client.review_many(seed)
        n = sys_.fetch_count
        out = client.review_many(
            [aug(pod_request(f"q{i}", clean[i % 24])["object"])
             for i in range(24)]
        )
        assert all(not o.by_target[TARGET].results for o in out)
        assert sys_.fetch_count == n, name
        assert drv.stats["interp_rendered_pairs"] == 0, name
        assert drv.stats["compiled_pairs"] == 24, name


def test_ttl_expiry_routes_rows_back(flagged_stub):
    """A key turns bad at the provider: inside the TTL both packages
    keep serving the cached clean answer; past it the next sweep
    refetches, the volatile row bits flag the rows again and they
    re-check on the interpreter — the bits are never cached on the
    corpus or the device."""
    stub, images, flagged, rng = flagged_stub
    now = [0.0]
    pods = _pods(images, rng, n=48)
    pair = _pair(stub, [(EXTERNAL_REGO, "K8sExternal")],
                 clock=lambda: now[0], cacheTTLSeconds=60)
    turned = next(c["image"] for c in pods[0]["spec"]["containers"]
                  if c["image"] not in flagged)
    got = {}
    for name, (client, drv, sys_) in pair.items():
        for p in pods:
            client.add_data(p)
        now[0] = 0.0
        first = _keys(client.audit().by_target[TARGET].results)
        flagged.add(turned)
        try:
            now[0] = 30.0  # inside the TTL: the cached clean answer holds
            inside = _keys(client.audit().by_target[TARGET].results)
            now[0] = 120.0  # past it: refetched, rows route back
            after = _keys(client.audit().by_target[TARGET].results)
        finally:
            flagged.discard(turned)
        got[name] = (first, inside, after, sys_.fetch_count)
    assert got["torch"] == got["tpu"]
    first, inside, after, fetches = got["torch"]
    assert inside == first
    n_turned = sum(any(c["image"] == turned for c in p["spec"]["containers"])
                   for p in pods)
    assert n_turned > 0
    assert len(after) > len(first)
    assert fetches == 2


def test_canaries_never_reach_the_provider(flagged_stub):
    """With the integrity plane wired, a set whose template calls
    external_data packs no canary rows: their synthetic keys would reach
    the real provider and add fetches to the batch's epoch."""
    from gatekeeper_tpu_torch.integrity import IntegrityPlane

    stub, images, flagged, rng = flagged_stub
    pair = _pair(stub, [(EXTERNAL_REGO, "K8sExternal")])
    client, drv, sys_ = pair["torch"]
    drv.set_integrity(IntegrityPlane())
    batch = [AugmentedUnstructured(p) for p in _pods(images, rng, n=24)]
    out = client.review_many(batch)
    assert sys_.fetch_count == 1
    wanted = {c["image"] for r in batch for c in r.object["spec"]["containers"]}
    assert set(stub.requests[-1]) == wanted
    assert sum(bool(o.by_target[TARGET].results) for o in out) > 0


# -- C4: one epoch's fetch covers every key, maxKeysPerRequest at a time ------


def test_epoch_fetch_chunks_by_max_keys_and_resolves_as_jax(stub_provider):
    """ROADMAP §C, C4, a standing divergence: one batch epoch of 6,002
    keys at the provider's default maxKeysPerRequest (512) makes
    ceil(6002 / 512) = 12 fetches in the port, every key cached; the
    JAX package sends the first 512 and fetches the rest as rows
    resolve them. Every resolved answer is the same in both."""
    rng = np.random.default_rng(4)
    keys = sorted({f"registry.example/img{int(k)}:v{int(k) % 7}"
                   for k in rng.choice(50_000, 6_002, replace=False)})
    for k in rng.choice(len(keys), 60, replace=False):
        keys[int(k)] = "bad-" + keys[int(k)]
    assert len(set(keys)) == 6_002
    order = [keys[int(i)] for i in rng.permutation(len(keys))]
    got = {}
    for name, cls in (("torch", ExternalDataSystem),
                      ("tpu", JExternalDataSystem)):
        n0 = len(stub_provider.requests)
        system = cls()
        system.upsert(stub_provider.provider_obj())
        assert system.get("stub-provider").max_keys == 512
        system.begin_batch()
        system.prefetch({"stub-provider": set(keys)})
        after_prefetch = system.fetch_count
        answers = [system.resolve("stub-provider", order[i:i + 8])
                   for i in range(0, len(order), 8)]
        got[name] = (answers, after_prefetch, system.fetch_count,
                     [len(r) for r in stub_provider.requests[n0:]])
    answers, after_prefetch, total, sizes = got["torch"]
    assert answers == got["tpu"][0]
    assert after_prefetch == total == 12
    assert sizes == [512] * 11 + [6_002 - 11 * 512]
    assert sum(len(a["errors"]) for a in answers) == 60
    # the reference: one request of 512 keys, then fetches by row
    assert got["tpu"][1] == 1 and got["tpu"][2] > 12
    assert got["tpu"][3][0] == 512


def test_failed_chunk_ends_the_epoch_fetch_and_keeps_earlier_chunks(
        stub_provider):
    """A chunk that fails records the epoch's failure as one failed fetch
    does: the chunks after it are not sent, resolve does not refetch
    within the epoch, and the keys of the chunks before it stay cached."""
    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj(maxKeysPerRequest=100))
    inner, calls = system.fetcher, []

    def fetch(p, keys):
        calls.append(list(keys))
        if len(calls) == 2:
            raise RuntimeError("chunk refused")
        return inner.fetch(p, keys)

    system.fetcher = type("F", (), {"fetch": staticmethod(fetch)})()
    keys = [f"k{i:04d}" for i in range(250)]
    system.begin_batch()
    system.prefetch({"stub-provider": set(keys)})
    assert [len(c) for c in calls] == [100, 100]
    assert system.fetch_count == 1
    states = system.cache.classify("stub-provider", keys)
    assert [states[k][0] for k in keys[:100]] == [HIT] * 100
    assert {states[k][0] for k in keys[100:]} == {MISS}
    r = system.resolve("stub-provider", keys[150:160])
    assert r["status_code"] == 500 and "chunk refused" in r["system_error"]
    assert len(calls) == 2  # no refetch within the epoch
    system.begin_batch()
    system.prefetch({"stub-provider": set(keys)})
    assert [len(c) for c in calls] == [100, 100, 100, 50]
    assert system.fetch_count == 3
