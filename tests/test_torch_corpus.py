"""The port's corpus analysis plane (gatekeeper_tpu_torch/analysis/
corpus.py) against the JAX package's on the CPU.

Seeded corpora of templates, constraints (live, dead, shadowed, with
mistyped and unknown parameters), mutators (one fights a validator) and
providers go through both packages' `corpus_from_docs`, and the same
policy loaded into each package's client through `corpus_from_live` and
`CorpusPlane`: whole reports (every diagnostic, dead, prunable and
shadowed keys) equal, `prunable_keys` equal at the current generation and
empty at a stale one, and the partition planner's statically excluded
keys equal. The bar is exact equality.
"""

import numpy as np
import pytest

from gatekeeper_tpu.analysis import corpus as jcorpus
from gatekeeper_tpu.constraint import (
    Backend as JBackend,
    K8sValidationTarget as JTarget,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu.mutation import MutationSystem as JMutationSystem
from gatekeeper_tpu.parallel.partition import (
    PartitionDispatcher as JPartitionDispatcher,
)
from gatekeeper_tpu_torch.analysis import corpus as tcorpus
from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.mutation import MutationSystem
from gatekeeper_tpu_torch.parallel.partition import PartitionDispatcher
from tests.test_torch_mutation import assign, assign_meta, modify_set

TARGET = "admission.k8s.gatekeeper.sh"

REQ_REGO = """package corpreq
violation[{"msg": msg}] {
    required := {key | key := input.parameters.labels[_]}
    provided := {key | input.review.object.metadata.labels[key]}
    missing := required - provided
    count(missing) > 0
    msg := sprintf("missing: %v", [missing])
}
"""

HOSTNET_REGO = """package corphostnet
violation[{"msg": msg}] {
    input.review.object.spec.hostNetwork
    msg := "hostNetwork is not allowed"
}
"""

EXT_REGO = """package corpext
violation[{"msg": msg}] {
    images := [img | img := input.review.object.spec.containers[_].image]
    response := external_data({"provider": "PROVIDER", "keys": images})
    count(response.errors) > 0
    msg := sprintf("image verification failed: %v", [response.errors])
}
"""

LABELS_SCHEMA = {"properties": {
    "labels": {"type": "array", "items": {"type": "string"}}}}


def template_doc(kind, rego, schema=None):
    crd = {"names": {"kind": kind}}
    if schema is not None:
        crd["validation"] = {"openAPIV3Schema": schema}
    return {"apiVersion": "templates.gatekeeper.sh/v1beta1",
            "kind": "ConstraintTemplate", "metadata": {"name": kind.lower()},
            "spec": {"crd": {"spec": crd},
                     "targets": [{"target": TARGET, "rego": rego}]}}


def constraint_doc(kind, name, match=None, params=None, action=None):
    spec = {}
    if match is not None:
        spec["match"] = match
    if params is not None:
        spec["parameters"] = params
    if action is not None:
        spec["enforcementAction"] = action
    return {"apiVersion": "constraints.gatekeeper.sh/v1beta1", "kind": kind,
            "metadata": {"name": name}, "spec": spec}


def provider_doc(name, policy):
    return {"apiVersion": "externaldata.gatekeeper.sh/v1alpha1",
            "kind": "Provider", "metadata": {"name": name},
            "spec": {"url": "http://127.0.0.1:1/v1", "timeout": 1,
                     "failurePolicy": policy}}


POD = {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}
MATCHES = [
    None, POD, {"namespaces": ["prod"]}, {"scope": "*"},
    {"kinds": [{"apiGroups": ["*"], "kinds": ["*"]}]},
    {"labelSelector": {"matchLabels": {"team": "core"}}},
    {"namespaces": ["a", "b"], "excludedNamespaces": ["a"]},
    dict(POD, namespaces=["prod", "dev"]),
    # provably dead
    {"kinds": []}, {"scope": "namespaced"},
    dict(POD, scope="Namespaced", namespaces=["ns-dead"],
         excludedNamespaces=["ns-dead"]),
    {"labelSelector": {"matchExpressions": [
        {"key": "team", "operator": "Exists"},
        {"key": "team", "operator": "DoesNotExist"}]}},
    dict(POD, scope="Namespaced", namespaces=["x"], excludedNamespaces=["x"],
         namespaceSelector={"matchLabels": {"team": "x"}}),
]


def seeded_corpus(seed):
    rng = np.random.default_rng(seed)
    templates = [template_doc("CorpReq", REQ_REGO, LABELS_SCHEMA),
                 template_doc("CorpHostNet", HOSTNET_REGO),
                 template_doc("CorpExt", EXT_REGO.replace("PROVIDER", "open")),
                 template_doc("CorpExtMissing",
                              EXT_REGO.replace("PROVIDER", "nowhere"))]
    constraints = []
    for i in range(14):
        kind = str(rng.choice(["CorpReq", "CorpHostNet", "CorpReq",
                               "CorpOrphan"]))
        match = MATCHES[int(rng.integers(len(MATCHES)))]
        params = None
        if kind == "CorpReq":
            params = [{"labels": ["owner"]}, {"labels": ["owner"]},
                      {"labels": "owner"}, {"labels": ["a"], "extra": 1}][
                int(rng.integers(4))]
        constraints.append(constraint_doc(
            kind, f"c{i:02d}", match=match, params=params,
            action=str(rng.choice(["deny", "dryrun"])) if i % 3 == 0
            else None))
    constraints.append(constraint_doc("CorpExt", "ext", match=POD))
    mutators = [
        assign("force-hostnet", "spec.hostNetwork", True, match=POD),
        assign_meta("owner", "metadata.labels.owner", "platform"),
        modify_set("args", "spec.containers[name: *].args", ["--v"]),
        assign("bad", "spec..x", 1),
    ]
    for i in range(int(rng.integers(1, 4))):
        mutators.append(assign(f"m{i}", f"spec.f{i}", i, match=MATCHES[
            int(rng.integers(7))]))
    providers = [provider_doc("open", "Ignore"), provider_doc("closed",
                                                              "Fail")]
    return templates, constraints, mutators, providers


def _src(docs, prefix):
    return [(f"{prefix}{i}", d) for i, d in enumerate(docs)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_corpus_from_docs_equals_jax(seed):
    t, c, m, p = seeded_corpus(seed)
    args = (_src(t, "t"), _src(c, "c"), _src(m, "m"), _src(p, "p"))
    got = tcorpus.corpus_from_docs(*args).to_dict()
    want = jcorpus.corpus_from_docs(*args).to_dict()
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_corpus_codes_cover_the_battery(seed):
    t, c, m, p = seeded_corpus(seed)
    args = (_src(t, "t"), _src(c, "c"), _src(m, "m"), _src(p, "p"))
    report = tcorpus.corpus_from_docs(*args)
    assert {"GK-C001", "GK-C002", "GK-C008"} <= set(report.codes)
    # the invalid mutator is the mutators lint's, not a corpus subject
    assert report.dead_keys
    assert report.subjects == sum(map(len, (t, c, m, p))) - 1


def _live(pkg, seed):
    t, c, m, _ = seeded_corpus(seed)
    if pkg == "torch":
        client = Backend(TorchDriver(device="cpu")).new_client(
            K8sValidationTarget())
        system = MutationSystem(device="cpu")
    else:
        client = JBackend(TpuDriver(use_jax=False)).new_client(JTarget())
        system = JMutationSystem()
    for doc in t[:2]:  # no external-data template: no provider system
        client.add_template(doc)
    for doc in c:
        try:  # mistyped parameters are refused at admission, as upstream
            client.add_constraint(doc)
        except Exception:
            pass
    for doc in m:
        try:
            system.upsert(doc)
        except Exception:
            pass
    return client, system


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corpus_plane_and_prunable_keys_equal_jax(seed):
    got = {}
    for pkg, mod, disp_cls in (("torch", tcorpus, PartitionDispatcher),
                               ("tpu", jcorpus, JPartitionDispatcher)):
        client, system = _live(pkg, seed)
        live = mod.corpus_from_live(client, system).to_dict()
        plane = mod.CorpusPlane(client, mutation_system=system,
                                debounce_s=3600.0)
        report = plane.refresh()
        gen = client._driver.constraint_generation()
        prunable = plane.prunable_keys(TARGET, gen)
        stale = plane.prunable_keys(TARGET, gen + 1)
        disp = disp_cls(client, TARGET, k=2, corpus=plane)
        try:
            plan = disp.plan()
            excluded = sorted(plan.excluded_static)
            kept = sorted(k for part in plan.partitions for k in part.keys)
        finally:
            disp.close()
        snap = plane.snapshot()
        got[pkg] = (live, report.to_dict(), sorted(prunable), stale,
                    excluded, kept, sorted(plane.shadowed_keys().items()),
                    {k: snap[k] for k in ("computed", "stale", "ok", "dead",
                                          "prunable", "shadowed")})
    assert got["torch"] == got["tpu"]
    live, _, prunable, stale, excluded, kept, _, snap = got["torch"]
    assert stale == frozenset()
    assert excluded == prunable and (prunable or seed == 0)
    assert not set(kept) & set(prunable)
    assert snap["computed"] and not snap["stale"]
