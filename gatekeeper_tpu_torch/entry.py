"""The harness step of the port: `entry()` builds the full-output audit
step (match kernel ∧ compiled template programs ∧ totals, one call) over a
self-contained policy state and returns it with its arguments.

Port of __graft_entry__.py's `entry()` and `_build_driver()`; the
templates, constraints, pods and gateways below are copied from that file
(lines 40-230), the Gateway inventory join included. The multi-device
dryrun is not ported: it needs more than one card.
"""

from __future__ import annotations

from typing import Any

TARGET = "admission.k8s.gatekeeper.sh"

# Self-contained ConstraintTemplates (original policy content, shaped like
# gatekeeper-library's general/* templates; nothing is read at run time).
_REQ_LABELS_REGO = """package graftlabels

violation[{"msg": msg, "details": {"missing": missing}}] {
    required := {key | key := input.parameters.labels[_]}
    provided := {key | input.review.object.metadata.labels[key]}
    missing := required - provided
    count(missing) > 0
    msg := sprintf("missing labels: %v", [missing])
}
"""

_NO_PRIV_REGO = """package graftpriv

violation[{"msg": msg}] {
    c := input.review.object.spec.containers[_]
    c.securityContext.privileged
    msg := sprintf("privileged container %v", [c.name])
}
"""


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


def _constraint(kind, name, params=None, match=None):
    spec = {}
    if params is not None:
        spec["parameters"] = params
    if match is not None:
        spec["match"] = match
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind,
        "metadata": {"name": name},
        "spec": spec,
    }


def _pod(i, overflow=False):
    labels = {"app": f"app{i % 3}"}
    # violators (pods missing "owner") are sparse, EXCEPT in overflow
    # corpora where they concentrate in the low row range so one chunk's
    # violating-row count exceeds the compaction window and forces the
    # hot-row redispatch (TorchDriver._redispatch_chunk)
    violates = i < 1600 if overflow else i % 16 == 0
    if not violates:
        labels["owner"] = "team"
    if i % 97 == 0:
        # routed to the uncompilable GraftDeepScan template's label
        # selector: a small interpreter-fallback population
        labels["deep"] = "scan"
    containers = [{"name": "main", "image": "nginx"}]
    if i % 5 == 0:
        containers.append(
            {
                "name": "side",
                "image": "busybox",
                "securityContext": {"privileged": True},
            }
        )
    if i % 1021 == 0:
        containers[0]["env"] = [
            {"name": "SECRET", "value": "forbidden-deep-value"}
        ]
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": f"p{i}", "namespace": "default", "labels": labels},
        "spec": {"containers": containers},
    }


_UNIQUE_HOST_REGO = """package graftuniquehost

violation[{"msg": msg}] {
    input.review.kind.kind == "Gateway"
    host := input.review.object.spec.host
    other := data.inventory.namespace[ns][apiv]["Gateway"][name]
    other.spec.host == host
    not same(other, input.review)
    msg := sprintf("host conflict: %v", [host])
}

same(obj, review) {
    obj.metadata.namespace == review.object.metadata.namespace
    obj.metadata.name == review.object.metadata.name
}
"""


def _gateway(i):
    # hosts collide in pairs: exercises the inventory-join screen +
    # the invdup row-feature refinement
    return {
        "apiVersion": "graft.example.com/v1",
        "kind": "Gateway",
        "metadata": {"name": f"gw{i}", "namespace": "default"},
        "spec": {"host": f"h{i // 2}.example.com"},
    }


# deliberately OUTSIDE the compilable subset (fixed array index — the
# compiler raises in every mode, so the program is None): forces a
# fallback-routed template, so the step exercises interpreter routing
_FALLBACK_REGO = """package graftdeep

violation[{"msg": msg}] {
    c := input.review.object.spec.containers[0]
    c.env[_].value == "forbidden-deep-value"
    msg := sprintf("forbidden env value on %v", [c.name])
}
"""


def _build_driver(n_resources: int, n_constraints: int = 3,
                  overflow: bool = False, device: Any = None):
    """A TorchDriver with templates, constraints and a synthetic corpus
    mounted: -> (driver, client, constraint set, encoded audit corpus)."""
    from .constraint import Backend, K8sValidationTarget
    from .constraint.torchdriver import TorchDriver

    drv = TorchDriver(device)
    client = Backend(drv).new_client(K8sValidationTarget())
    client.add_template(_template("GraftRequiredLabels", _REQ_LABELS_REGO))
    client.add_template(_template("GraftNoPrivileged", _NO_PRIV_REGO))
    client.add_template(_template("GraftUniqueHost", _UNIQUE_HOST_REGO))
    client.add_template(_template("GraftDeepScan", _FALLBACK_REGO))
    pod_match = {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}
    client.add_constraint(
        _constraint(
            "GraftRequiredLabels", "need-owner",
            params={"labels": ["owner"]}, match=pod_match,
        )
    )
    client.add_constraint(
        _constraint("GraftNoPrivileged", "no-priv", match=pod_match)
    )
    client.add_constraint(
        _constraint(
            "GraftUniqueHost",
            "unique-host",
            match={
                "kinds": [
                    {"apiGroups": ["graft.example.com"], "kinds": ["Gateway"]}
                ]
            },
        )
    )
    client.add_constraint(
        _constraint(
            "GraftDeepScan",
            "no-deep",
            match={
                "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
                "labelSelector": {"matchLabels": {"deep": "scan"}},
            },
        )
    )
    # fill the budget with labels constraints, all satisfied by the
    # universal "app" label (the unused "v" parameter makes each a
    # distinct program with identical consts)
    for i in range(max(0, n_constraints - 4)):
        client.add_constraint(
            _constraint(
                "GraftRequiredLabels",
                f"need-l{i}",
                params={"labels": ["app"], "v": i},
                match=pod_match,
            )
        )
    for i in range(n_resources):
        client.add_data(_pod(i, overflow=overflow))
    for i in range(6):
        client.add_data(_gateway(i))
    with drv._mutex:
        corpus = drv._audit_corpus(TARGET)
        cs = drv._constraint_set(TARGET)
    drv.patterns.sync()
    drv.tables.sync()
    return drv, client, cs, corpus


def entry(device: Any = None):
    """-> (fn, args): the full-output audit step over 16 pods and 6
    gateways; `fn(*args)` gives (match, counts, totals) on the device (the
    card unless the caller asks for the CPU)."""
    drv, _, cs, corpus = _build_driver(n_resources=16, device=device)
    fn, args, _ = drv.kernel.prepare(
        cs.programs, cs.ms, corpus.fb, corpus.tok, corpus.g
    )
    return fn, args
