"""The port's mutation package (gatekeeper_tpu_torch/mutation) against the
JAX package's on the CPU.

Inputs are made from numpy seeds and go through both packages: the
location-path grammar (parse, render, errors), each mutator kind's apply
(Assign with pathTests and assignIf, AssignMetadata, ModifySet merge and
prune), schema conflicts, the fixpoint engine (iterations and
ConvergenceError), the GK-M0xx lint codes, JSONPatch rendering, and the
batch screen: the port's MutationSystem.screen (K1's plain torch version on
CPU tensors) against the JAX package's (its jitted match_matrix on the
CPU) on seeded mutators with live label and namespace selectors, label-
overflow rows included. The bar is exact equality.
"""

import copy
import functools

import numpy as np
import pytest

from gatekeeper_tpu import mutation as jm
from gatekeeper_tpu.mutation import lint as jlint
from gatekeeper_tpu.mutation import patch as jpatch
from gatekeeper_tpu.mutation import system as jsystem
from gatekeeper_tpu_torch import mutation as tm
from gatekeeper_tpu_torch.mutation import lint as tlint
from gatekeeper_tpu_torch.mutation import patch as tpatch
from gatekeeper_tpu_torch.mutation import system as tsystem

POD_V1 = [{"groups": [""], "versions": ["v1"], "kinds": ["Pod"]}]


def assign(name, location, value, match=None, params=None, apply_to=POD_V1):
    spec = {"applyTo": apply_to, "location": location,
            "parameters": {"assign": {"value": value}, **(params or {})}}
    if match is not None:
        spec["match"] = match
    return {"apiVersion": "mutations.gatekeeper.sh/v1alpha1",
            "kind": "Assign", "metadata": {"name": name}, "spec": spec}


def assign_meta(name, location, value, match=None):
    spec = {"location": location, "parameters": {"assign": {"value": value}}}
    if match is not None:
        spec["match"] = match
    return {"apiVersion": "mutations.gatekeeper.sh/v1alpha1",
            "kind": "AssignMetadata", "metadata": {"name": name},
            "spec": spec}


def modify_set(name, location, values, operation="merge", match=None):
    spec = {"applyTo": POD_V1, "location": location,
            "parameters": {"operation": operation,
                           "values": {"fromList": values}}}
    if match is not None:
        spec["match"] = match
    return {"apiVersion": "mutations.gatekeeper.sh/v1alpha1",
            "kind": "ModifySet", "metadata": {"name": name}, "spec": spec}


def pod(rng, i, ns="default", n_labels=None):
    labels = {}
    for k in ("app", "env", "tier", "team")[: int(rng.integers(0, 5))
                                            if n_labels is None else 0]:
        labels[k] = str(rng.choice(["web", "worker", "prod", "dev"]))
    for j in range(n_labels or 0):
        labels[f"extra-{j}"] = f"v{j}"
    containers = [
        {"name": f"c{j}", "image": f"nginx:{j}",
         **({"args": [f"--x{j}"]} if rng.random() < 0.5 else {}),
         **({"imagePullPolicy": "IfNotPresent"} if rng.random() < 0.3
            else {})}
        for j in range(int(rng.integers(1, 4)))
    ]
    meta = {"name": f"p{i}", "namespace": ns}
    if labels:
        meta["labels"] = labels
    if rng.random() < 0.3:
        meta["annotations"] = {"owner": "someone"}
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"containers": containers}}


def review_for(obj, operation="CREATE"):
    ns = obj["metadata"].get("namespace", "")
    return {"kind": {"group": "", "version": "v1", "kind": obj["kind"]},
            "operation": operation, "name": obj["metadata"]["name"],
            "namespace": ns, "object": obj}


def _nodes(nodes):
    return [(type(n).__name__, tuple(vars(n).values())) for n in nodes]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # both packages raise their own classes
        return ("raise", type(e).__name__, str(e))


# -- path grammar ------------------------------------------------------------

PATHS = [
    "spec.containers[name: *].image",
    'spec.containers[name: "side car"].securityContext.runAsUser',
    'metadata.labels."my.dotted/key"',
    "spec.template.spec.containers[ name : web ].args",
    'metadata.annotations."a\\"b"',
    "spec", "", "   ", "spec..x", "spec.", "spec.x[name]", "spec.x[: v]",
    "spec.x[k: ]", 'spec."unterminated', "spec.x[k: v", "spec.x[k: v]y",
]


@pytest.mark.parametrize("path", PATHS)
def test_path_parse_and_render_equal_jax(path):
    def run(pkg):
        nodes = pkg.parse_path(path)
        rendered = pkg.render_path(nodes)
        return _nodes(nodes), rendered, _nodes(pkg.parse_path(rendered))

    got, want = _outcome(lambda: run(tm)), _outcome(lambda: run(jm))
    assert got == want
    if got[0] == "ok":
        assert got[1][0] == got[1][2]  # parse . render . parse = parse


# -- each kind's apply -------------------------------------------------------

MUTATORS = [
    assign("pull-always", "spec.containers[name: *].imagePullPolicy",
           "Always"),
    assign("keyed-new", 'spec.containers[name: "sidecar"].image', "envoy"),
    assign("deep", "spec.securityContext.runAsNonRoot", True),
    assign("if-absent", "spec.containers[name: *].imagePullPolicy", "Never",
           params={"pathTests": [{
               "subPath": "spec.containers[name: *].imagePullPolicy",
               "condition": "MustNotExist"}]}),
    assign("must-exist", "spec.priorityClassName", "high",
           params={"pathTests": [{"subPath": "spec.containers",
                                  "condition": "MustExist"}]}),
    assign("assign-if-in", "spec.containers[name: c0].imagePullPolicy",
           "Always", params={"assignIf": {"in": ["IfNotPresent"]}}),
    assign("assign-if-notin", "spec.dnsPolicy", "Default",
           params={"assignIf": {"notIn": ["ClusterFirst"]}}),
    assign("not-a-pod", "spec.x", 1, apply_to=[
        {"groups": ["apps"], "versions": ["v1"], "kinds": ["Deployment"]}]),
    assign_meta("owner-label", "metadata.labels.owner", "platform"),
    assign_meta("owner-annotation", "metadata.annotations.owner", "other"),
    assign_meta("cost-center", 'metadata.labels."example.com/cost"', "42"),
    modify_set("args-merge", "spec.containers[name: *].args",
               ["--x0", "--log=json"]),
    modify_set("args-prune", "spec.containers[name: *].args", ["--x1"],
               operation="prune"),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("doc", MUTATORS, ids=lambda d: d["metadata"]["name"])
def test_each_kind_applies_as_jax(doc, seed):
    rng = np.random.default_rng(seed)
    t_mut, j_mut = tm.mutator_from_obj(doc), jm.mutator_from_obj(doc)
    for i in range(6):
        obj = pod(rng, i)
        review = review_for(obj)
        snapshot = copy.deepcopy(obj)
        got = _outcome(lambda: t_mut.apply(obj, review))
        want = _outcome(lambda: j_mut.apply(copy.deepcopy(obj), review))
        assert got == want
        assert obj == snapshot  # the input is never modified
        gvk = ("", "v1", "Pod")
        assert t_mut.applies_to(*gvk) == j_mut.applies_to(*gvk)


@pytest.mark.parametrize("doc", [
    assign("meta", "metadata.labels.x", "v"),
    assign_meta("spec-loc", "spec.x", "v"),
    {"apiVersion": "mutations.gatekeeper.sh/v1alpha1", "kind": "Assign",
     "metadata": {"name": "no-loc"}, "spec": {"applyTo": POD_V1}},
    assign("bad-path", "spec.x[", 1),
    modify_set("bad-op", "spec.args", ["a"], operation="replace"),
    {"apiVersion": "mutations.gatekeeper.sh/v1alpha1", "kind": "Unknown",
     "metadata": {"name": "u"}, "spec": {}},
], ids=lambda d: d["metadata"]["name"])
def test_spec_errors_equal_jax(doc):
    assert _outcome(lambda: tm.mutator_from_obj(doc).id) == _outcome(
        lambda: jm.mutator_from_obj(doc).id)


def test_assign_type_mismatch_raises_as_jax():
    doc = assign("into-scalar", "spec.containers.name", "x")
    obj = pod(np.random.default_rng(3), 0)
    got = _outcome(lambda: tm.mutator_from_obj(doc).apply(
        obj, review_for(obj)))
    want = _outcome(lambda: jm.mutator_from_obj(doc).apply(
        obj, review_for(obj)))
    assert got == want and got[0] == "raise"


# -- schema conflicts, order, the fixpoint -----------------------------------

CONFLICT_SETS = [
    [assign("a", "spec.x.y", 1), assign("b", "spec.x[name: n].y", 2)],
    [assign("a", "spec.l[name: n].v", 1), assign("b", "spec.l[id: n].v", 2),
     assign("c", "spec.l[name: m].w", 3)],
    [assign("a", "spec.x", 1), assign("b", "spec.x.y", 2)],
    [assign("a", "spec.x.y", 1), assign("b", "spec.x.z", 2),
     modify_set("c", "spec.x[name: *].args", ["q"])],
]


@pytest.mark.parametrize("docs", CONFLICT_SETS)
def test_schema_conflicts_and_order_equal_jax(docs):
    got = {}
    for name, pkg in (("torch", tm), ("tpu", jm)):
        for order in (docs, docs[::-1]):
            s = pkg.MutationSystem() if pkg is jm else pkg.MutationSystem(
                device="cpu")
            for d in order:
                s.upsert(d)
            got.setdefault(name, []).append(
                (s.conflicts(), [m.id for m in s.ordered()], s.count()))
    assert got["torch"] == got["tpu"]
    assert got["torch"][0] == got["torch"][1]  # ingestion-order free


def test_fixpoint_iterations_and_convergence_error_equal_jax():
    chain = [
        assign("a-needs-b", "spec.priorityClassName", "high",
               params={"pathTests": [{"subPath": "spec.schedulerName",
                                      "condition": "MustExist"}]}),
        assign("b-sets", "spec.schedulerName", "custom"),
    ]
    flip = [
        assign("flip-a", "spec.phase", "a",
               params={"assignIf": {"in": [None, "b"]}}),
        assign("flip-b", "spec.phase", "b",
               params={"assignIf": {"in": [None, "a"]}}),
    ]
    rng = np.random.default_rng(9)
    for docs in (chain, flip, MUTATORS):
        systems = [tm.MutationSystem(device="cpu"), jm.MutationSystem()]
        for s in systems:
            for d in docs:
                s.upsert(d)
        for i in range(4):
            obj = pod(rng, i)
            got, want = (_outcome(lambda: s.apply(obj, review_for(obj)))
                         for s in systems)
            assert got == want
            if docs is chain:
                assert got[0] == "ok" and got[1][1] >= 2
            if docs is flip:
                assert got[1] == "ConvergenceError"


# -- lint ---------------------------------------------------------------------


def test_lint_codes_equal_jax():
    docs = [(f"doc{i}.yaml", d) for i, d in enumerate([
        assign("ok", "spec.containers[name: *].imagePullPolicy", "Always"),
        assign("bad-path", "spec.x[k", 1),
        {"apiVersion": "mutations.gatekeeper.sh/v1alpha1", "kind": "Assign",
         "metadata": {"name": "no-loc"},
         "spec": {"applyTo": POD_V1, "location": 7}},
        assign_meta("outside", "spec.x", "v"),
        assign("in-meta", "metadata.labels.x", "v"),
        modify_set("bad-values", "spec.args", "notalist"),
        {"apiVersion": "mutations.gatekeeper.sh/v1alpha1", "kind": "Other",
         "metadata": {"name": "kind"}, "spec": {}},
        assign("c1", "spec.q.r", 1),
        assign("c2", "spec.q[name: n].r", 2),
    ])]
    got = [x.to_dict() for x in tlint.lint_mutators(docs)]
    want = [x.to_dict() for x in jlint.lint_mutators(docs)]
    assert got == want
    codes = {c for x in got for c in x["codes"]}
    assert {"GK-M001", "GK-M002", "GK-M003", "GK-M004", "GK-M005",
            "GK-M006", "GK-M007"} <= codes
    assert [tlint.is_mutator_doc(d) for _, d in docs] == [
        jlint.is_mutator_doc(d) for _, d in docs]


# -- JSONPatch ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [5, 6])
def test_json_patch_equal_jax(seed):
    rng = np.random.default_rng(seed)
    s = tm.MutationSystem(device="cpu")
    for d in MUTATORS:
        s.upsert(d)
    for i in range(8):
        obj = pod(rng, i)
        out, _ = s.apply(obj, review_for(obj))
        ops = tpatch.json_patch(obj, out)
        assert ops == jpatch.json_patch(obj, out)
        assert tpatch.apply_patch(obj, ops) == out
        assert jpatch.apply_patch(obj, ops) == out


# -- the batch screen ---------------------------------------------------------

LABELS = (("app", ("web", "worker")), ("env", ("prod", "dev")),
          ("tier", ("front", "back")))


def rand_match(rng):
    match = {}
    r = rng.random()
    if r < 0.4:
        match["kinds"] = [{"apiGroups": [""], "kinds": ["Pod"]}]
    elif r < 0.5:
        match["kinds"] = [{"apiGroups": ["*"], "kinds": ["*"]}]
    if rng.random() < 0.25:
        match["namespaces"] = [str(x) for x in rng.choice(
            ["default", "prod", "dev", "kube-system"], 2, replace=False)]
    if rng.random() < 0.2:
        match["excludedNamespaces"] = [str(rng.choice(["prod", "dev"]))]
    if rng.random() < 0.2:
        match["scope"] = str(rng.choice(["*", "Namespaced", "Cluster"]))
    if rng.random() < 0.5:
        key, vals = LABELS[int(rng.integers(len(LABELS)))]
        op = str(rng.choice(["In", "NotIn", "Exists", "DoesNotExist"]))
        expr = {"key": key, "operator": op}
        if op in ("In", "NotIn"):
            expr["values"] = [str(vals[int(rng.integers(2))])]
        sel = {"matchExpressions": [expr]}
        if rng.random() < 0.5:
            k2, v2 = LABELS[int(rng.integers(len(LABELS)))]
            sel["matchLabels"] = {k2: str(v2[int(rng.integers(2))])}
        match["labelSelector"] = sel
    if rng.random() < 0.25:
        match["namespaceSelector"] = {"matchExpressions": [{
            "key": "env", "operator": str(rng.choice(
                ["In", "Exists", "DoesNotExist"])), "values": ["prod"]}]}
    return match


def screen_corpus(seed, n_mutators=18, n_reviews=40, wide=0):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n_mutators):
        k = i % 3
        if k == 0:
            docs.append(assign_meta(f"am{i}", f"metadata.labels.k{i}", "v",
                                    match=rand_match(rng)))
        elif k == 1:
            docs.append(assign(f"as{i}", f"spec.f{i}", i,
                               match=rand_match(rng)))
        else:
            docs.append(modify_set(f"ms{i}", "spec.containers[name: c0].args",
                                   [f"--{i}"], match=rand_match(rng)))
    reviews = []
    for i in range(n_reviews):
        ns = str(rng.choice(["default", "prod", "dev", ""]))
        obj = pod(rng, i, ns=ns or "default",
                  n_labels=8 if i < wide else None)
        rev = review_for(obj)
        if not ns:
            rev.pop("namespace")
        if rng.random() < 0.3:
            rev["_unstable"] = {"namespace": {"metadata": {
                "name": ns, "labels": {"env": str(rng.choice(
                    ["prod", "dev"]))}}}}
        if rng.random() < 0.15:
            rev["operation"] = "UPDATE"
            rev["oldObject"] = pod(rng, i, ns=ns or "default")
        reviews.append(rev)
    return docs, reviews


def _systems(docs):
    t, j = tm.MutationSystem(device="cpu"), jm.MutationSystem()
    for d in docs:
        t.upsert(d)
        j.upsert(d)
    return t, j


@pytest.mark.parametrize("seed", [11, 12, 13, 5309])
def test_screen_equals_jax_on_live_selectors(seed):
    docs, reviews = screen_corpus(seed)
    t, j = _systems(docs)
    t_muts, t_mat = t.screen(reviews)
    j_muts, j_mat = j.screen(reviews)
    h_muts, h_mat = t.screen_host(reviews)
    assert [m.id for m in t_muts] == [m.id for m in j_muts] == [
        m.id for m in h_muts]
    assert t_mat.dtype == j_mat.dtype == bool
    assert t_mat.tolist() == j_mat.tolist() == h_mat.tolist()
    assert t_mat.any() and not t_mat.all()
    assert sum("labelSelector" in (m.match or {}) for m in t_muts) >= 4
    assert t.screen_dispatches == 1


@pytest.mark.parametrize("seed", [21, 22])
def test_screen_label_overflow_rows_recheck_as_jax(seed, monkeypatch):
    """Rows whose labels do not fit the batch's label width re-check on
    the host oracle in both packages. The screen sizes that width to the
    batch, so the test caps it at 4 for both."""
    for mod, cap in ((tsystem, tsystem.batch_review_features),
                     (jsystem, jsystem.batch_review_features)):
        monkeypatch.setattr(mod, "batch_review_features",
                            functools.partial(cap, max_labels=4))
    docs, reviews = screen_corpus(seed, wide=6)
    t, j = _systems(docs)
    hosted = []
    inner = t._screen_host_one
    monkeypatch.setattr(t, "_screen_host_one", lambda muts, r, ns: (
        hosted.append(r["object"]["metadata"]["name"]) or inner(muts, r, ns)))
    _, t_mat = t.screen(reviews)
    _, j_mat = j.screen(reviews)
    _, h_mat = t.screen_host(reviews)
    assert hosted[:6] == [f"p{i}" for i in range(6)]
    assert t_mat.tolist() == j_mat.tolist() == h_mat.tolist()


def test_screen_spec_tensors_cached_per_generation():
    docs, reviews = screen_corpus(31, n_mutators=6, n_reviews=8)
    t, _ = _systems(docs)
    t.screen(reviews)
    cached = t._spec_cache
    t.screen(reviews)
    assert t._spec_cache is cached
    assert all(v.device.type == "cpu" for v in cached[2].values())
    t.upsert(assign("late", "spec.late", 1))
    t.screen(reviews)
    assert t._spec_cache is not cached and t._spec_cache[0] == t.generation
