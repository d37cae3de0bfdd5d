# Copied from gatekeeper_tpu/integrity/canary.py; unchanged.
"""Canary synthesis + verdict digesting (docs/robustness.md §Verdict
integrity).

A canary is a synthetic review whose ground-truth verdict set is
computed ONCE on the host interpreter and pinned as a digest; the
driver then rides K canaries in the padding slots every fused dispatch
already wastes (`padding_waste_rows_total`) and compares the device's
answer against the pinned digest. By the driver-parity contract the
fused path must reproduce the interpreter verdicts byte-for-byte, so
ANY digest mismatch is a corruption signal — never a policy outcome.

Synthesis is deterministic: the same constraint set always derives the
same canary reviews (and therefore the same golden digests) on every
replica, so golden sidecars are portable and a fleet's canary verdicts
are comparable. Reviews are mined from the constraints themselves —
parameter strings (denied registries, required annotation keys, memory
ceilings) are folded into pod shapes engineered to VIOLATE typical
templates, because a canary whose verdict set is empty cannot catch a
device that silently suppresses violations.
"""

from __future__ import annotations

import hashlib
import json
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "result_digest",
    "split_digests",
    "synth_agent_reviews",
    "synth_reviews",
]

# how many distinct canary shapes synth_reviews derives by default —
# small on purpose: canaries ride free in padding slots, but golden
# derivation pays one interpreter evaluation per canary per signature
DEFAULT_K = 4


def _stable(s: str) -> int:
    """Deterministic small hash (NOT Python's salted hash())."""
    return zlib.crc32(s.encode("utf-8", "replace"))


def _mine_params(constraints: Sequence[Dict[str, Any]]) -> Dict[str, list]:
    """Pull the parameter atoms canary pods should embed: annotation /
    label keys a template may require, registry prefixes it may deny.
    Best-effort — an unrecognised parameter shape just mines nothing."""
    ann_keys: List[str] = []
    label_keys: List[str] = []
    registries: List[str] = []
    for c in constraints:
        spec = c.get("spec") or {}
        params = spec.get("parameters") or {}
        if not isinstance(params, dict):
            continue
        for key, into in (
            ("annotations", ann_keys),
            ("labels", label_keys),
            ("registries", registries),
            ("repos", registries),
        ):
            v = params.get(key)
            if isinstance(v, list):
                for item in v:
                    if isinstance(item, str):
                        into.append(item)
                    elif isinstance(item, dict):
                        k = item.get("key") or item.get("name")
                        if isinstance(k, str):
                            into.append(k)
    return {
        "annotations": ann_keys,
        "labels": label_keys,
        "registries": registries,
    }


def _canary_metadata(i: int, mined: Dict[str, list]) -> Dict[str, Any]:
    metadata: Dict[str, Any] = {"name": f"integrity-canary-{i}"}
    if i % 3 == 1:
        # compliant-ish variant: carries every mined annotation/label
        # key so "required X" templates see this one pass
        metadata["annotations"] = {
            k: "integrity-canary" for k in mined["annotations"]
        } or {"integrity.gatekeeper/canary": "true"}
        metadata["labels"] = {
            k: "canary" for k in mined["labels"]
        } or {"app": "integrity-canary"}
    return metadata


def _canary_pod(i: int, mined: Dict[str, list]) -> Dict[str, Any]:
    """One deterministic pod spec engineered to trip common template
    families: index 0 is maximally-violating (no labels/annotations,
    denied-registry `:latest` image, absurd memory, privileged), later
    indices flip one dimension each so single-constraint corruption
    still has a verdict delta to corrupt."""
    registries = mined["registries"] or ["docker.io/"]
    reg = registries[i % len(registries)]
    image = (
        f"{reg}library/canary:latest"
        if i % 2 == 0
        else "pinned.example.com/canary:v1.2.3"
    )
    metadata = _canary_metadata(i, mined)
    memory = "64Gi" if i % 2 == 0 else "64Mi"
    container: Dict[str, Any] = {
        "name": "c0",
        "image": image,
        "resources": {"limits": {"memory": memory}},
    }
    if i % 3 != 1:
        # violating variants also run privileged, so pod-security
        # templates (privileged-container family) have a verdict to
        # corrupt; the compliant variant stays unprivileged
        container["securityContext"] = {"privileged": True}
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": metadata,
        "spec": {"containers": [container]},
    }


def _canary_service(i: int, mined: Dict[str, list]) -> Dict[str, Any]:
    """A Service-shaped canary for constraints whose match kinds never
    see a Pod (the block-nodeport family): violating variants ask for
    NodePort, the compliant one stays ClusterIP."""
    metadata = _canary_metadata(i, mined)
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": metadata,
        "spec": {
            "type": "ClusterIP" if i % 3 == 1 else "NodePort",
            "ports": [{"port": 80, "targetPort": 8080}],
        },
    }


def _mine_kinds(constraints: Sequence[Dict[str, Any]]) -> List[str]:
    """Distinct object kinds the constraint set's match blocks name
    (order-stable). Empty / wildcard match blocks contribute nothing —
    the caller falls back to Pod."""
    seen: List[str] = []
    for c in constraints:
        match = (c.get("spec") or {}).get("match") or {}
        for sel in match.get("kinds") or []:
            if not isinstance(sel, dict):
                continue
            for k in sel.get("kinds") or []:
                if isinstance(k, str) and k != "*" and k not in seen:
                    seen.append(k)
    return seen


def synth_reviews(
    constraints: Sequence[Dict[str, Any]],
    k: int = DEFAULT_K,
    group_kind: Tuple[str, str, str] = ("", "v1", "Pod"),
) -> List[Dict[str, Any]]:
    """Derive `k` deterministic gkReview dicts (the post-handle_review
    shape the driver evaluates) from a constraint set. Alternates
    cluster-scoped reviews (which can never autoreject — match.py's
    review_autorejects) with namespaced reviews carrying an `_unstable`
    namespace object, so namespaceSelector templates get coverage
    without tripping the not-synced-namespace autoreject."""
    mined = _mine_params(constraints)
    seed = _stable(
        "|".join(
            sorted(
                f'{c.get("kind", "")}/'
                f'{(c.get("metadata") or {}).get("name", "")}'
                for c in constraints
            )
        )
    )
    group, version, kind = group_kind
    # spread the kinds the match blocks actually name across the set
    # in contiguous blocks (a Service-only constraint set would
    # otherwise never see a canary it can match; blocks, not
    # round-robin, so each kind still gets both the violating and the
    # compliant index parities); unrecognised kinds fall back to pods.
    # A set whose match blocks name nothing concrete (wildcard / no
    # match) gets BOTH built-in shapes, so kind-specific templates
    # reached via a wildcard match still see a shape they can convict
    kinds = _mine_kinds(constraints) or [kind, "Service"]
    n = max(1, int(k))
    reviews: List[Dict[str, Any]] = []
    for i in range(n):
        obj_kind = kinds[(i * len(kinds)) // n]
        if obj_kind == "Service":
            obj = _canary_service(i, mined)
        else:
            obj_kind = kind
            obj = _canary_pod(i, mined)
        review: Dict[str, Any] = {
            "uid": f"integrity-canary-{seed:08x}-{i}",
            "kind": {"group": group, "version": version,
                     "kind": obj_kind},
            "operation": "CREATE",
            "name": obj["metadata"]["name"],
            "userInfo": {"username": "system:integrity-canary"},
            "object": obj,
            "_unstable": {},
        }
        if i % 2 == 1:
            ns = f"canary-ns-{i}"
            review["namespace"] = ns
            obj["metadata"]["namespace"] = ns
            # the attached namespace object suppresses autoreject and
            # feeds namespaceSelector matching, mirroring what
            # augment_request does for a synced namespace
            review["_unstable"] = {
                "namespace": {
                    "apiVersion": "v1",
                    "kind": "Namespace",
                    "metadata": {
                        "name": ns,
                        "labels": {"integrity-canary": "true"},
                    },
                }
            }
        reviews.append(review)
    return reviews


def _mine_agent(constraints: Sequence[Dict[str, Any]]) -> Dict[str, list]:
    """Parameter/match atoms for agent-action canaries: concrete tool
    names satisfying the constraints' tool globs, capability label
    keys their selectors require, and the allow-list values (commands,
    domains, required argument names) the parameters pin."""
    tools: List[str] = []
    caps: List[str] = []
    allowed: List[str] = []
    domains: List[str] = []
    required: List[str] = []
    for c in constraints:
        spec = c.get("spec") or {}
        match = spec.get("match") or {}
        for t in match.get("tools") or []:
            if not isinstance(t, str):
                continue
            if t == "*":
                tool = "canary.invoke"
            elif t.endswith(".*"):
                tool = f"{t[:-2]}.canary"
            else:
                tool = t
            if tool not in tools:
                tools.append(tool)
        sel = match.get("capabilities")
        if isinstance(sel, dict):
            for k in (sel.get("matchLabels") or {}):
                if isinstance(k, str) and k not in caps:
                    caps.append(k)
            for expr in sel.get("matchExpressions") or []:
                k = (expr or {}).get("key")
                if isinstance(k, str) and (expr or {}).get(
                    "operator"
                ) in ("Exists", "In") and k not in caps:
                    caps.append(k)
        params = spec.get("parameters") or {}
        if isinstance(params, dict):
            for key, into in (
                ("allowed", allowed),
                ("domains", domains),
                ("required", required),
            ):
                v = params.get(key)
                if isinstance(v, list):
                    into.extend(x for x in v if isinstance(x, str))
    return {
        "tools": tools,
        "caps": caps,
        "allowed": allowed,
        "domains": domains,
        "required": required,
    }


def synth_agent_reviews(
    constraints: Sequence[Dict[str, Any]],
    k: int = DEFAULT_K,
) -> List[Dict[str, Any]]:
    """Deterministic agent-action canaries (the agent.action target's
    counterpart of synth_reviews), normalized through
    AgentActionTarget.review_of — the exact serving shape. Three
    variants cycle: empty-arguments (trips required-argument shapes),
    compliant (signed skill, allow-listed values), and bad-values
    (denied command/host, unsigned skill, a `bad`-keyed skill digest so
    pinned-stub external-data lookups answer with an error)."""
    from ..agentaction import AgentActionTarget

    mined = _mine_agent(constraints)
    seed = _stable(
        "|".join(
            sorted(
                f'{c.get("kind", "")}/'
                f'{(c.get("metadata") or {}).get("name", "")}'
                for c in constraints
            )
        )
    )
    tools = mined["tools"] or ["canary.invoke"]
    target = AgentActionTarget()
    reviews: List[Dict[str, Any]] = []
    for i in range(max(1, int(k))):
        compliant = i % 3 == 1
        if compliant:
            arguments: Dict[str, Any] = {
                r: "integrity-canary" for r in mined["required"]
            }
            arguments["command"] = (
                mined["allowed"][0] if mined["allowed"] else "true"
            )
            arguments["host"] = (
                mined["domains"][0] if mined["domains"]
                else "canary.example.com"
            )
            skill = {
                "name": "integrity-canary-skill",
                "signed": True,
                "publisher": "first-party",
                "digest": f"pinned-canary-{seed:08x}",
            }
        elif i % 3 == 2:
            # bad-values variant: present but denied everywhere
            arguments = {r: "integrity-canary" for r in mined["required"]}
            arguments["command"] = "integrity-canary-denied"
            arguments["host"] = "canary.invalid"
            skill = {
                "name": "integrity-canary-skill",
                "signed": False,
                "publisher": "integrity-canary",
                "digest": f"bad-canary-{seed:08x}",
            }
        else:
            # empty-arguments variant: trips required-argument shapes
            arguments = {}
            skill = {
                "name": "integrity-canary-skill",
                "signed": False,
                "publisher": "integrity-canary",
                "digest": f"bad-canary-{seed:08x}",
            }
        record = {
            "id": f"integrity-canary-{seed:08x}-{i}",
            "agent": "system:integrity-canary",
            "session": "integrity-canary",
            "tool": tools[i % len(tools)],
            "arguments": arguments,
            "capabilities": list(mined["caps"]) or ["integrity-canary"],
            "skill": skill,
        }
        reviews.append(target.review_of(record))
    return reviews


def result_digest(results: Optional[Sequence[Any]]) -> str:
    """Order-insensitive digest of one review's verdict set: sorted
    (kind, constraint name, message, enforcement action) tuples. Merge
    order differs between the monolithic and partitioned paths
    (`merge_partition_results` re-sorts), so the digest must not."""
    rows = []
    for r in results or ():
        c = getattr(r, "constraint", None) or {}
        meta = c.get("metadata") or {} if isinstance(c, dict) else {}
        kind = c.get("kind", "") if isinstance(c, dict) else ""
        rows.append(
            (
                str(kind),
                str(meta.get("name", "")),
                str(getattr(r, "msg", "")),
                str(getattr(r, "enforcement_action", "")),
            )
        )
    rows.sort()
    payload = json.dumps(rows, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def split_digests(split: Sequence[Sequence[Any]]) -> List[str]:
    """Per-review digests for a review-major result split."""
    return [result_digest(rs) for rs in split]
