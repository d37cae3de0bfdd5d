"""Inventory-join templates on the port, on the CPU.

Seeded mixed-GVK corpora (chip_smoke.make_mixed rows) under the two
uniqueness fixtures (chip_smoke.UNIQUE_INGRESS_HOST_REGO and
UNIQUE_SERVICE_SELECTOR_REGO, in the shape of gatekeeper-library's
uniqueingresshost and uniqueserviceselector) and the inline inventory
joins of the JAX driver's tests (a cross-path join, a self-join without
the identity guard, a join inside one definition of a two-definition
helper). For each: a Client over TorchDriver(device="cpu") gives the same
audit() and review_many() result lists, in the same order, as the port's
interpreter driver and the JAX TpuDriver; every "invdup" row-feature plane
equals the JAX driver's bit for bit (audit corpus and review batches);
and the prune-index render count equals the JAX driver's. Tolerance: none,
every compared value is a bool, an int or a string.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

import chip_smoke
from gatekeeper_tpu.constraint import (
    AugmentedUnstructured as JAug,
    Backend as JBackend,
    K8sValidationTarget as JTarget,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu_torch.constraint import (
    AugmentedUnstructured as TAug,
    Backend as TBackend,
    K8sValidationTarget as TTarget,
    RegoDriver as TRegoDriver,
)
from gatekeeper_tpu_torch.constraint import torchdriver as torchdriver_mod
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver

TARGET = chip_smoke.TARGET


def _template(kind, rego):
    return {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": kind.lower()},
        "spec": {
            "crd": {"spec": {"names": {"kind": kind}}},
            "targets": [{"target": TARGET, "rego": rego}],
        },
    }


def _constraint(kind, name):
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind,
        "metadata": {"name": name},
        "spec": {},
    }


def _ingress(name, ns, rules):
    return {
        "apiVersion": "networking.k8s.io/v1beta1",
        "kind": "Ingress",
        "metadata": {"name": name, "namespace": ns},
        "spec": {"rules": rules},
    }


def _service(name, ns, sel):
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "namespace": ns},
        "spec": {"selector": sel},
    }


def _widget(name, ns, spec):
    return {
        "apiVersion": "v1",
        "kind": "Widget",
        "metadata": {"name": name, "namespace": ns},
        "spec": spec,
    }


# the inline inventory joins of tests/test_tpu_driver.py
CROSSPATH_REGO = """package crosspath

violation[{"msg": "uses an existing priority class"}] {
    input.review.object.spec.priorityClassName == data.inventory.cluster[_]["PriorityClass"][name].metadata.name
}
"""

SELFJOIN_REGO = """package selfjoin

violation[{"msg": "host exists in inventory"}] {
    input.review.object.spec.host == data.inventory.namespace[_][_]["Widget"][_].spec.host
}
"""

MULTIDEF_REGO = """package multidef

violation[{"msg": "v"}] {
    check(input.review.object)
}

check(o) {
    o.spec.host == data.inventory.cluster[_][_][_].spec.host
}

check(o) {
    o.spec.big == "yes"
}
"""


def _mixed_rows(seed, n=140, span=2700):
    """A seeded sample of make_mixed rows, with the rows of blocks 0 and
    1 (one duplicated selector, two duplicated hosts) always in."""
    rng = np.random.default_rng(seed)
    ids = set(rng.choice(span, n, replace=False).tolist())
    ids |= {17, 117, 18, 118, 57, 157, 19}
    return [chip_smoke.make_mixed(i) for i in sorted(ids)]


def _uniqueness(seed, fallback_row=False):
    rows = _mixed_rows(seed)
    rows += [
        # same selector, keys in another order
        _service("s-a", "ns1", {"app": "web", "tier": "fe"}),
        _service("s-b", "ns2", {"tier": "fe", "app": "web"}),
        # one ingress sharing two hosts with two others: one candidate
        # per inventory path; and an object-map rules partner
        _ingress("multi", "ns1", [{"host": "m1.example"}, {"host": "m2.example"}]),
        _ingress("m1", "ns2", [{"host": "m1.example"}]),
        _ingress("m2", "ns3", {"r": {"host": "m2.example"}}),
    ]
    if fallback_row:
        # 70 rules: past the device fanout cap, so the row routes to the
        # interpreter and the inventory counts cannot see its keys
        rows.append(_ingress(
            "wide", "ns4", [{"host": f"w{i}.example"} for i in range(70)]
        ))
    rng = np.random.default_rng(seed + 100)
    reviews = []
    for j in range(16):
        src = rows[int(rng.integers(len(rows)))]
        if src["kind"] in ("Service", "Ingress") and j % 2 == 0:
            obj = json.loads(json.dumps(src))  # a key the inventory holds
        elif j % 3 == 0:
            obj = _ingress(f"new{j}", "ns5", [{"host": f"fresh{j}.example"}])
        elif j % 3 == 1:
            obj = _service(f"new{j}", "ns5", {"app": f"fresh{j}"})
        else:
            obj = chip_smoke.make_pod(int(rng.integers(1, 500)))
        obj["metadata"]["name"] = f"admit-{j}"
        reviews.append(obj)
    reviews += [
        _ingress("admit-m", "ns6", [{"host": "m2.example"}]),
        _service("admit-s", "ns6", {"app": "web", "tier": "fe"}),
    ]
    templates = chip_smoke.template_docs()[:4] + chip_smoke.uniqueness_templates()
    constraints = chip_smoke.constraint_docs(8)
    constraints = [c for c in constraints if c["kind"] in {
        t["spec"]["crd"]["spec"]["names"]["kind"] for t in templates}]
    return templates, constraints + chip_smoke.uniqueness_constraints(), rows, reviews


def _selfjoin(seed):
    rng = np.random.default_rng(seed)
    hosts = [f"h{int(x)}.example" for x in rng.integers(0, 6, 12)]
    rows = [_widget(f"w{i}", f"d{i % 3}", {"host": h}) for i, h in enumerate(hosts)]
    reviews = [_widget("new-a", "d0", {"host": hosts[0]}),
               _widget("new-b", "d1", {"host": "absent.example"})] * 7
    return ([_template("SelfJoin", SELFJOIN_REGO)], [_constraint("SelfJoin", "sj")],
            rows, reviews)


def _crosspath(seed):
    rng = np.random.default_rng(seed)
    rows = [{"apiVersion": "scheduling.k8s.io/v1", "kind": "PriorityClass",
             "metadata": {"name": n}} for n in ("high", "low")]
    for i in range(10):
        pc = ["high", "mid", "low", None][int(rng.integers(4))]
        extra = {"priorityClassName": pc} if pc else {}
        p = chip_smoke.make_pod(i + 1, max_containers=2, name=f"p{i}")
        p["spec"].update(extra)
        rows.append(p)
    reviews = rows[2:] + rows[2:]
    return ([_template("CrossPath", CROSSPATH_REGO)], [_constraint("CrossPath", "cp")],
            rows, [json.loads(json.dumps(r)) for r in reviews])


def _multidef(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(10):
        rows.append(_widget(f"w{i}", "d", {
            "host": f"h{int(rng.integers(0, 4))}.example",
            "big": "yes" if rng.random() < 0.3 else "no",
        }))
    reviews = [json.loads(json.dumps(r)) for r in rows] * 2
    return ([_template("MultiDef", MULTIDEF_REGO)], [_constraint("MultiDef", "m")],
            rows, reviews)


SCENARIOS = {
    "uniqueness-0": lambda: _uniqueness(0),
    "uniqueness-1": lambda: _uniqueness(1),
    "uniqueness-fallback-row": lambda: _uniqueness(2, fallback_row=True),
    "selfjoin": lambda: _selfjoin(3),
    "crosspath": lambda: _crosspath(4),
    "multidef": lambda: _multidef(5),
}


def _build(backend, target, driver, scenario):
    templates, constraints, rows, _ = scenario
    client = backend(driver).new_client(target())
    for t in templates:
        client.add_template(t)
    for c in constraints:
        client.add_constraint(c)
    for r in rows:
        client.add_data(json.loads(json.dumps(r)))
    return client


def _spy_bits(drv):
    """Record every _row_feature_bits answer: [(data_gen, corpus, bits)]."""
    seen = []
    orig = drv._row_feature_bits

    def spy(target, corpus, names):
        out = orig(target, corpus, names)
        seen.append((corpus.data_gen, corpus,
                     {k: np.asarray(v).copy() for k, v in out.items()}))
        return out

    drv._row_feature_bits = spy
    return seen


def _keys(results):
    return [chip_smoke.result_key(r) for r in results]


@functools.lru_cache(maxsize=None)
def _run(name):
    """Audit and one review batch of scenario `name` through all three
    drivers, with every row-feature answer recorded."""
    scenario = SCENARIOS[name]()
    reviews = scenario[3]
    t_drv, j_drv = TorchDriver(device="cpu"), TpuDriver()
    t_bits, j_bits = _spy_bits(t_drv), _spy_bits(j_drv)
    clients = {
        "torch": _build(TBackend, TTarget, t_drv, scenario),
        "rego": _build(TBackend, TTarget, TRegoDriver(), scenario),
        "tpu": _build(JBackend, JTarget, j_drv, scenario),
    }
    out = {"name": name, "t_drv": t_drv, "j_drv": j_drv,
           "t_bits": t_bits, "j_bits": j_bits}
    out["audit"] = {
        k: _keys(c.audit().by_target[TARGET].results) for k, c in clients.items()
    }
    out["audit_stats"] = (dict(t_drv.stats), dict(j_drv.stats))
    j_batch = [JAug(json.loads(json.dumps(r))) for r in reviews]
    n_seen = len(j_bits)
    assert clients["tpu"].warm_review_path(j_batch)
    del j_bits[n_seen:]  # the warm-up's own (coarse) answers
    out["review"] = {}
    for k, c in clients.items():
        aug = JAug if k == "tpu" else TAug
        batch = j_batch if k == "tpu" else [aug(json.loads(json.dumps(r))) for r in reviews]
        out["review"][k] = [_keys(r.by_target[TARGET].results) for r in c.review_many(batch)]
    out["review_stats"] = (dict(t_drv.stats), dict(j_drv.stats))
    return out


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def run(request):
    return _run(request.param)


def test_audit_identical(run):
    a = run["audit"]
    assert a["torch"] == a["rego"]
    assert a["torch"] == a["tpu"]
    assert a["rego"], "the scenario produced no violation"


def test_review_many_identical(run):
    r = run["review"]
    assert r["torch"] == r["rego"]
    assert r["torch"] == r["tpu"]
    assert any(r["rego"]), "the review batch produced no violation"
    assert run["review_stats"][0]["compiled_pairs"] > 0


def test_program_routes_like_jax(run):
    """Same programs: screens with the same row features and prune plans."""
    t_cs = run["t_drv"]._cset[TARGET]
    j_cs = run["j_drv"]._cset[TARGET]
    for tp, jp in zip(t_cs.programs, j_cs.programs):
        assert (tp is None) == (jp is None)
        if tp is not None:
            assert tp.row_features == jp.row_features
            assert tp.prune == jp.prune
            assert tp.screen == jp.screen
    assert any(p is not None and p.screen for p in t_cs.programs)


def test_row_feature_planes_equal_jax(run):
    """Every invdup plane the drivers computed, audit corpus and review
    batch alike, bit for bit."""
    t, j = run["t_bits"], run["j_bits"]
    assert [g >= 0 for g, _, _ in t] == [g >= 0 for g, _, _ in j]
    for (tg, _, tb), (jg, _, jb) in zip(t, j):
        assert sorted(tb) == sorted(jb)
        for name in tb:
            assert tb[name].dtype == jb[name].dtype == np.bool_
            assert np.array_equal(tb[name], jb[name]), (tg, name)
    if run["t_drv"]._cset[TARGET].programs and any(
        p is not None and p.row_features for p in run["t_drv"]._cset[TARGET].programs
    ):
        assert t, "no row feature was computed"
        assert {g >= 0 for g, _, _ in t} == {True, False}


def test_pruned_renders_equal_jax(run):
    for t_stats, j_stats in (run["audit_stats"], run["review_stats"]):
        assert t_stats["pruned_renders"] == j_stats["pruned_renders"]
        assert t_stats["interp_rendered_pairs"] == j_stats["interp_rendered_pairs"]
    if run["name"].startswith("uniqueness"):
        assert run["audit_stats"][0]["pruned_renders"] > 0
        assert run["review_stats"][0]["pruned_renders"] > 0


def _audit_plane(run):
    (t_corpus,) = {id(c): c for g, c, _ in run["t_bits"] if g >= 0}.values()
    bits = [b for g, _, b in run["t_bits"] if g >= 0][0]
    (name, plane), = bits.items()
    return t_corpus, name, plane


def test_threshold_self_excluded():
    """uniqueingresshost proves `not identical(...)`: on a corpus without
    fallback rows a host must be carried by two rows (threshold 2), so
    exactly the members of duplicated-host groups (and rows missing an
    identity field) are flagged."""
    scenario = _uniqueness(0)
    drv = TorchDriver(device="cpu")
    bits = _spy_bits(drv)
    _build(TBackend, TTarget, drv, scenario).audit()
    corpus = bits[0][1]
    assert not corpus.row_fallback.any()
    (name, plane), = bits[0][2].items()
    assert name.split(":")[3] == "1"
    flagged = {
        (r["object"]["metadata"].get("namespace"), r["object"]["metadata"]["name"])
        for r, b in zip(corpus.reviews, plane) if b
        and r["object"]["kind"] == "Ingress"
    }
    # the object-map rules row keeps its host off the leaf pattern
    # spec.rules[#].host: it is a partner only, never flagged by the bit
    off_leaf = {
        (o["metadata"]["namespace"], o["metadata"]["name"]) for o in scenario[2]
        if o["kind"] == "Ingress" and isinstance(o["spec"]["rules"], dict)
    }
    want = chip_smoke.uniqueness_groups(scenario[2])["K8sUniqueIngressHost"]
    assert off_leaf and flagged == want - off_leaf and flagged


def test_threshold_not_self_excluded():
    """Without the identity guard (the self-join) every row carrying a key
    joins itself: the threshold is 1 and every widget is flagged."""
    _, name, plane = _audit_plane(_run("selfjoin"))
    assert name.split(":")[3] == "0"
    assert plane.all()


def test_fallback_row_drops_threshold():
    """A fallback row's keys are invisible to the counts: the audit
    threshold drops to 1 (every Ingress with a host on the leaf pattern
    spec.rules[#].host flagged) and a review batch routes every row."""
    run = _run("uniqueness-fallback-row")
    corpus, _, plane = _audit_plane(run)
    assert corpus.row_fallback.any()
    listed = np.array([
        r["object"]["kind"] == "Ingress"
        and isinstance(r["object"]["spec"]["rules"], list)
        for r in corpus.reviews
    ])
    assert listed.sum() > 5 and plane[listed].all()
    for g, _, bits in run["t_bits"]:
        if g < 0:
            assert all(b.all() for b in bits.values())


def test_overlay_alias_guard():
    """Base vocab ids interned after a review batch's overlay snapshot
    alias its overlay ids: both drivers then route every row."""
    scenario = _uniqueness(0)
    drivers = (TorchDriver(device="cpu"), TpuDriver())
    planes = []
    for drv, (backend, target, aug) in zip(
        drivers, ((TBackend, TTarget, TAug), (JBackend, JTarget, JAug))
    ):
        client = _build(backend, target, drv, scenario)
        client.audit()
        seen = _spy_bits(drv)
        batch = [aug(json.loads(json.dumps(r))) for r in scenario[3]]
        if drv is drivers[1]:
            assert client.warm_review_path(batch)
            seen.clear()
        client.review_many(batch)
        (_, corpus, before), = [x for x in seen if x[0] < 0]
        assert not all(b.all() for b in before.values())
        drv.vocab.intern("p:a.path.interned.after.the.snapshot")
        corpus.row_feats = None
        after = drv._row_feature_bits(TARGET, corpus, sorted(before))
        assert all(np.asarray(b).all() for b in after.values())
        planes.append({k: np.asarray(v) for k, v in after.items()})
    assert sorted(planes[0]) == sorted(planes[1])
    for k in planes[0]:
        assert np.array_equal(planes[0][k], planes[1][k])


def test_prune_index_candidates_deduped():
    """A review sharing two hosts with one inventory object gets that
    object once: the pruned inventory holds each path once."""
    drv = TorchDriver(device="cpu")
    scenario = _uniqueness(0)
    client = _build(TBackend, TTarget, drv, scenario)
    client.audit()
    seen = []
    orig = drv._eval_template

    def spy(target, constraint, review, inventory, trace, frozen_review=None):
        seen.append(inventory)
        return orig(target, constraint, review, inventory, trace,
                    frozen_review=frozen_review)

    drv._eval_template = spy
    rev = _ingress("twice", "ns9", [{"host": "m1.example"}, {"host": "m2.example"}])
    res = client.review(TAug(json.loads(json.dumps(rev)))).by_target[TARGET].results
    ref = _build(TBackend, TTarget, TRegoDriver(), scenario)
    want = ref.review(TAug(rev)).by_target[TARGET].results
    assert _keys(res) == _keys(want) and want
    assert drv.stats["pruned_renders"] == 1
    (inv,) = seen
    ns = inv["namespace"]
    paths = [(n, a, k, o) for n in ns for a in ns[n] for k in ns[n][a] for o in ns[n][a][k]]
    assert sorted(p[3] for p in paths) == ["m1", "m2", "multi"]


def test_extdata_feature_raises(monkeypatch):
    """A program reading an external-data row feature no longer raises
    (the port has an external-data plane): with no
    ExternalDataSystem wired, the feature's bits route every row to the
    interpreter's re-check, so the results equal the interpreter
    driver's; the bits are staged volatile and never cached on the
    corpus."""
    orig = torchdriver_mod.compile_program

    def with_extdata(env, modules, params):
        prog = orig(env, modules, params)
        return dataclasses.replace(
            prog, row_features=prog.row_features + ("extdata:K8sX:err",)
        )

    monkeypatch.setattr(torchdriver_mod, "compile_program", with_extdata)
    scenario = _selfjoin(0)
    drv = TorchDriver(device="cpu")
    client = _build(TBackend, TTarget, drv, scenario)
    got = client.audit().by_target[TARGET].results
    ref = _build(TBackend, TTarget, TRegoDriver(), scenario)
    want = ref.audit().by_target[TARGET].results
    assert _keys(got) == _keys(want) and want
    assert "extdata:K8sX:err" not in drv._corpus[TARGET].row_feats


def test_hot_row_redispatch_reads_the_same_bits(monkeypatch):
    """A chunk whose hot rows overflow the compaction window reruns alone
    with the chunk's row feature planes: same results, and the same
    pruned renders as the sweep without the rerun (a rerun without the
    planes would flag every Ingress and render more pairs)."""
    ref = _run("uniqueness-0")
    monkeypatch.setattr(torchdriver_mod, "R_CAP", 4)
    drv = TorchDriver(device="cpu")
    client = _build(TBackend, TTarget, drv, SCENARIOS["uniqueness-0"]())
    got = _keys(client.audit().by_target[TARGET].results)
    assert drv.stats["hot_redispatches"] > 0
    assert got == ref["audit"]["rego"]
    assert drv.stats["pruned_renders"] == ref["audit_stats"][0]["pruned_renders"]
