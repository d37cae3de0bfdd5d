"""Partition-scoped review on the port's fused path, on the CPU:
`Client.review_many_subset` over TorchDriver(device="cpu") against the
JAX package's TpuDriver (`TpuDriver.query_many_subset`) on the same
templates, constraints, synced objects and review batches.

  * per subset (the constraint keys split into three by `keys[p::3]`),
    results equal the reference's: same results, order and messages;
  * merged across the subsets in `constraint_keys` order (the JAX
    `merge_partition_results`), they equal the port's own `review_many`;
  * an empty subset and one naming an unknown key give empty responses; a
    path other than `hooks[...].violation` raises ValueError;
  * a constraint added after a subset was served rebuilds that subset;
  * after a warm-up, reviews alternating between the whole set and two
    subsets stage no policy and upload no table whole;
  * with the host interpreter's query paths made to raise, the subset
    review still answers: no evaluation falls back to the interpreter.
"""

import copy

import pytest

import chip_smoke
from gatekeeper_tpu.constraint import (
    AdmissionRequest as JRequest,
    AugmentedUnstructured as JAug,
    Backend as JBackend,
    K8sValidationTarget as JTarget,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu.parallel.partition import merge_partition_results
from gatekeeper_tpu_torch.constraint import (
    AdmissionRequest as TRequest,
    AugmentedUnstructured as TAug,
    Backend as TBackend,
    K8sValidationTarget as TTarget,
)
from gatekeeper_tpu_torch.constraint import driver as tdriver
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver

TARGET = chip_smoke.TARGET
PATH = f'hooks["{TARGET}"].violation'
N_CONSTRAINTS = 12
POD_IDS = [0, 3, 499, 503, 509, 521, 541, 998, 1006, 1527]


def _ns_selector_constraint():
    """One constraint reading the review's Namespace: reviews in a
    namespace that is not synced autoreject."""
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sRequiredLabels",
        "metadata": {"name": "prod-owner"},
        "spec": {
            "match": {
                "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
                "namespaceSelector": {"matchLabels": {"env": "prod"}},
            },
            "parameters": {"labels": [{"key": "owner"}]},
        },
    }


def _namespace(i):
    return {
        "apiVersion": "v1", "kind": "Namespace",
        "metadata": {"name": f"ns{i}",
                     "labels": {"env": "prod" if i % 2 == 0 else "dev"}},
    }


def _client(backend, target, driver):
    client = backend(driver).new_client(target())
    for t in chip_smoke.template_docs():
        client.add_template(t)
    for c in chip_smoke.constraint_docs(N_CONSTRAINTS):
        client.add_constraint(c)
    client.add_constraint(_ns_selector_constraint())
    for i in range(12):
        client.add_data(_namespace(i))
    for i in POD_IDS:
        client.add_data(chip_smoke.make_pod(i))
    return client


# each package's review wrappers: unstructured objects, and admission
# requests (whose namespace field can autoreject)
TORCH, TPU = (TAug, TRequest), (JAug, JRequest)


def _batch(pkg, seed, size=24):
    aug, request = pkg
    out = []
    for j in range(size):
        pod = chip_smoke.make_pod(
            [1, 499, 503, 509, 521, 541, 3][(seed + j) % 7] * (j + 1),
            name=f"sub-{seed}-{j}",
        )
        pod["metadata"]["labels"]["release"] = f"r{seed}-{j}"
        if j % 3 == 0:
            pod["spec"]["containers"][0]["image"] = f"docker.io/novel{seed}x{j}"
        if j % 4 == 1:
            pod["metadata"]["labels"].pop("owner", None)
        if j % 2:
            out.append(aug(pod))
        else:
            out.append(request({
                "kind": {"group": "", "version": "v1", "kind": "Pod"},
                "name": pod["metadata"]["name"],
                "namespace": pod["metadata"]["namespace"],
                "object": pod,
            }))
    return out


def _keys(results):
    return [chip_smoke.result_key(r) for r in results]


def _subsets(keys, k=3):
    return [frozenset(keys[p::k]) for p in range(k)]


@pytest.fixture(scope="module")
def clients():
    t_drv, j_drv = TorchDriver(device="cpu"), TpuDriver()
    return {
        "torch": (_client(TBackend, TTarget, t_drv), t_drv),
        "tpu": (_client(JBackend, JTarget, j_drv), j_drv),
    }


def _subset_review(client, pkg, seed, subset):
    return [
        r.by_target[TARGET].results if TARGET in r.by_target else []
        for r in client.review_many_subset(_batch(pkg, seed), subset)
    ]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("part", [0, 1, 2])
def test_subset_equals_reference(clients, seed, part):
    t_client, t_drv = clients["torch"]
    j_client, j_drv = clients["tpu"]
    keys = t_drv.constraint_keys(TARGET)
    assert keys == j_drv.constraint_keys(TARGET)
    subset = _subsets(keys)[part]
    got = [_keys(r) for r in _subset_review(t_client, TORCH, seed, subset)]
    want = [_keys(r) for r in _subset_review(j_client, TPU, seed, subset)]
    assert got == want
    assert sum(len(w) for w in want) > 0
    # every result names a constraint of the subset
    assert {k[1] for rs in got for k in rs} <= {k.split("/")[1] for k in subset}
    assert t_drv.stats["n_constraints"] == len(subset)
    assert t_drv.stats["compiled_pairs"] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_merged_subsets_equal_monolith(clients, seed):
    t_client, t_drv = clients["torch"]
    keys = t_drv.constraint_keys(TARGET)
    order = {k: i for i, k in enumerate(keys)}
    parts = [_subset_review(t_client, TORCH, seed, s) for s in _subsets(keys)]
    mono = [r.by_target[TARGET].results
            for r in t_client.review_many(_batch(TORCH, seed))]
    merged = [merge_partition_results([p[i] for p in parts], order)
              for i in range(len(mono))]
    assert [_keys(m) for m in merged] == [_keys(m) for m in mono]
    # the batch holds autoreject results and evaluated ones alike
    msgs = [r.msg for rs in mono for r in rs]
    assert tdriver.AUTOREJECT_MSG in msgs
    assert any(m != tdriver.AUTOREJECT_MSG for m in msgs)


@pytest.mark.parametrize("subset", [frozenset(), frozenset({"Nope/x"})])
def test_subset_without_constraints_is_empty(clients, subset):
    t_client, t_drv = clients["torch"]
    j_client, _ = clients["tpu"]
    got = [_keys(r) for r in _subset_review(t_client, TORCH, 0, subset)]
    want = [_keys(r) for r in _subset_review(j_client, TPU, 0, subset)]
    assert got == want == [[] for _ in got]
    resps = t_drv.query_many_subset(PATH, [{"review": {}}] * 3, subset)
    assert [r.results for r in resps] == [[], [], []]


def test_non_violation_path_raises(clients):
    _, t_drv = clients["torch"]
    with pytest.raises(ValueError, match="unsupported partition query path"):
        t_drv.query_many_subset(f'hooks["{TARGET}"].audit', [{}], {"a/b"})


def test_subset_rebuilds_after_constraint_added():
    drivers = {"torch": TorchDriver(device="cpu"), "tpu": TpuDriver()}
    clients = {
        "torch": _client(TBackend, TTarget, drivers["torch"]),
        "tpu": _client(JBackend, JTarget, drivers["tpu"]),
    }
    extra = _ns_selector_constraint()
    extra["metadata"]["name"] = "late"
    del extra["spec"]["match"]["namespaceSelector"]
    extra_key = f"{extra['kind']}/late"
    subset = frozenset(drivers["torch"].constraint_keys(TARGET)[::2]) | {extra_key}
    pkg = {"torch": TORCH, "tpu": TPU}
    before = {k: _subset_review(c, pkg[k], 0, subset) for k, c in clients.items()}
    cs = drivers["torch"]._cset_sub[(TARGET, subset)]
    for c in clients.values():
        c.add_constraint(copy.deepcopy(extra))
    after = {k: _subset_review(c, pkg[k], 0, subset) for k, c in clients.items()}
    rebuilt = drivers["torch"]._cset_sub[(TARGET, subset)]
    assert rebuilt is not cs and len(rebuilt.constraints) == len(cs.constraints) + 1
    for res in (before, after):
        assert [_keys(r) for r in res["torch"]] == [_keys(r) for r in res["tpu"]]
    late = [k for rs in after["torch"] for k in _keys(rs) if k[1] == "late"]
    assert late and not any(
        k[1] == "late" for rs in before["torch"] for k in _keys(rs))


def test_alternating_sets_restage_nothing(clients):
    t_client, t_drv = clients["torch"]
    keys = t_drv.constraint_keys(TARGET)
    a, b = _subsets(keys)[:2]
    kernel = t_drv.kernel

    def cycle(seed):
        t_client.review_many(_batch(TORCH, seed))
        _subset_review(t_client, TORCH, seed, a)
        _subset_review(t_client, TORCH, seed, b)

    cycle(0)  # warm-up: every set staged once
    stages, uploads = kernel.policy_stages, dict(kernel.uploads)
    for seed in (1, 2, 3):
        cycle(seed)
    assert kernel.policy_stages == stages
    assert kernel.uploads["full_uploads"] == uploads["full_uploads"]
    assert kernel.uploads == uploads
    # each subset's slab columns are the whole set's
    whole = t_drv._cset[TARGET].policy
    for s in (a, b):
        assert t_drv._cset_sub[(TARGET, s)].policy.cols == whole.cols


def test_subset_takes_no_interpreter_route(clients, monkeypatch):
    t_client, t_drv = clients["torch"]
    j_client, _ = clients["tpu"]
    subset = _subsets(t_drv.constraint_keys(TARGET))[1]
    want = [_keys(r) for r in _subset_review(j_client, TPU, 1, subset)]

    def refuse(*a, **kw):
        raise AssertionError("host interpreter query")

    monkeypatch.setattr(TorchDriver, "query_host", refuse)
    monkeypatch.setattr(tdriver.RegoDriver, "_violation", refuse)
    monkeypatch.setattr(tdriver.Driver, "query_many_subset", refuse)
    got = [_keys(r) for r in _subset_review(t_client, TORCH, 1, subset)]
    assert got == want and sum(len(w) for w in want) > 0
    assert t_drv.stats["compiled_pairs"] > 0


def test_interpreter_driver_subset_equals_reference(clients):
    """The port's RegoDriver serves the same call on the host (the
    interpreter is that engine's evaluation, not a fallback)."""
    j_client, j_drv = clients["tpu"]
    r_client = _client(TBackend, TTarget, tdriver.RegoDriver())
    for subset in _subsets(j_drv.constraint_keys(TARGET)):
        got = [_keys(r) for r in _subset_review(r_client, TORCH, 0, subset)]
        want = [_keys(r) for r in _subset_review(j_client, TPU, 0, subset)]
        assert got == want


def test_stage_policy_refuses_a_narrower_column_map(clients):
    _, t_drv = clients["torch"]
    t_client = clients["torch"][0]
    t_client.review_many(_batch(TORCH, 0))
    cs = t_drv._cset[TARGET]
    narrow = {k: v[:-1] for k, v in cs.policy.cols.items()}
    with pytest.raises(ValueError, match="outside the given column map"):
        t_drv.kernel.stage_policy(cs.programs, cs.ms, cols=narrow)
