"""The port's agent-action plane (gatekeeper_tpu_torch/agentaction) against
the JAX package's on the CPU, exact, with no tolerance.

Inputs are made from numpy seeds: tool-call records over agents, tool
namespaces, capability shapes and skill provenance, and agent constraints
over the whole match schema (tool globs `*`, `ns.*` and exact names,
`agents`/`excludedAgents`, capability and skill selectors). Pinned here:

  * `split_tool`, record normalization (`review_of`, `handle_review`,
    `handle_violation`, `AgentAction` records) and `match_ir`, equal
    across the packages;
  * the `validate_constraint` glob grammar, the same verdict in both;
  * match parity: the host oracle and K1's plain version agree bit for bit
    over seeded constraints x actions, in each package, and the port's
    bits equal the JAX package's;
  * the agent audit over ingested actions and `synth_agent_reviews`, equal;
  * the /v1/agent/review contract at small size: 24 concurrent requests,
    3 templates (one external_data) and an Assign mutator; one fused
    dispatch per micro-batch, one K1 mutation screen, and every answer's
    body equal to the JAX package's WebhookServer's;
  * the genericity gate over gatekeeper_tpu_torch/;
  * the standing fail-policy divergence: the port answers a failed fused
    agent batch with the fail policy, the JAX package on its interpreter.
"""

import ast
import base64
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from gatekeeper_tpu.agentaction import (
    AgentAction as JAgentAction,
    AgentActionTarget as JAgentTarget,
    SkillRecord as JSkillRecord,
    split_tool as j_split_tool,
)
from gatekeeper_tpu.constraint import (
    Backend as JBackend,
    InvalidConstraintError as JInvalidConstraintError,
    K8sValidationTarget as JK8sTarget,
    RegoDriver as JRegoDriver,
)
from gatekeeper_tpu_torch.agentaction import (
    AGENT_API_VERSION,
    BARE_TOOL_GROUP,
    TARGET_NAME,
    AgentAction,
    AgentActionTarget,
    SkillRecord,
    make_agent_plane,
    split_tool,
)
from gatekeeper_tpu_torch.constraint import (
    Backend,
    InvalidConstraintError,
    K8sValidationTarget,
)
from gatekeeper_tpu_torch.constraint.driver import RegoDriver
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver

from test_agentaction import (
    PARITY_ACTIONS,
    PARITY_MATCHES,
    SHELL_REGO,
    SIGNED_REGO,
    VERIFIED_REGO,
    agent_constraint,
    agent_template,
)

K8S_TARGET = "admission.k8s.gatekeeper.sh"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "gatekeeper_tpu_torch")

AGENTS = [f"planner-{i}" for i in range(6)] + ["coder", ""]
TOOLS = ["shell.exec", "shell.run", "net.fetch", "net.post", "fs.read",
         "fs.write", "fetch", "search", "a.b.c", ""]
CAPS = ["exec", "net", "fs", "read", "write"]
PUBLISHERS = ["acme", "first-party", "community"]
COMMANDS = ["ls", "cat", "rm", "curl", "true"]


def seeded_records(seed: int, n: int):
    """n tool-call records drawn from a numpy seed: agents, tools (dotted,
    dotless, empty), capability lists, maps or none, skill provenance with
    and without a signature, digests a stub provider answers with an
    error ("bad") or a value."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        caps = [CAPS[j] for j in np.flatnonzero(r.random(len(CAPS)) < 0.4)]
        shape = int(r.integers(3))
        capabilities = (
            caps if shape == 0
            else {c: str(r.integers(2) == 1).lower() for c in caps}
            if shape == 1 else None
        )
        rec = {
            "id": f"call-{seed}-{i}",
            "agent": AGENTS[int(r.integers(len(AGENTS)))],
            "session": f"s-{int(r.integers(3))}",
            "tool": TOOLS[int(r.integers(len(TOOLS)))],
            "arguments": {"command": COMMANDS[int(r.integers(len(COMMANDS)))]},
        }
        if capabilities is not None:
            rec["capabilities"] = capabilities
        if r.random() < 0.85:
            skill = {"name": f"skill-{int(r.integers(4))}",
                     "publisher": PUBLISHERS[int(r.integers(3))],
                     "digest": ("bad-" if r.random() < 0.25 else "sha256:")
                     + f"{int(r.integers(16)):02x}"}
            if r.random() < 0.75:
                skill["signed"] = bool(r.random() < 0.7)
            rec["skill"] = skill
        out.append(rec)
    return out


def _selector(r, keys, values):
    if r.random() < 0.5:
        k = keys[int(r.integers(len(keys)))]
        return {"matchLabels": {k: values[int(r.integers(len(values)))]}}
    op = ["In", "NotIn", "Exists", "DoesNotExist"][int(r.integers(4))]
    expr = {"key": keys[int(r.integers(len(keys)))], "operator": op}
    if op in ("In", "NotIn"):
        expr["values"] = list(values[: 1 + int(r.integers(len(values)))])
    return {"matchExpressions": [expr]}


def seeded_matches(seed: int, n: int):
    """n agent match blocks over the whole schema, from a numpy seed."""
    r = np.random.default_rng(seed)
    globs = ["*", "shell.*", "net.*", "fs.*", "shell.exec", "net.fetch",
             "fetch", "search", "a.b.c"]
    out = []
    for _ in range(n):
        m = {}
        if r.random() < 0.7:
            m["tools"] = [globs[int(j)] for j in
                          r.choice(len(globs), 1 + int(r.integers(3)),
                                   replace=False)]
        if r.random() < 0.3:
            m["agents"] = [AGENTS[int(r.integers(6))]]
        if r.random() < 0.3:
            m["excludedAgents"] = [AGENTS[int(r.integers(6))]]
        if r.random() < 0.3:
            m["capabilities"] = _selector(r, CAPS, ["true", "false"])
        if r.random() < 0.3:
            m["skills"] = _selector(
                r, ["publisher", "signed", "name"],
                PUBLISHERS + ["skill-0", "skill-1"],
            )
        out.append(m)
    return out


# -- normalization -----------------------------------------------------------


def test_split_tool_equal():
    assert split_tool("shell.exec") == ("shell", "exec")
    assert split_tool("a.b.c") == ("a", "b.c")
    assert split_tool("fetch") == (BARE_TOOL_GROUP, "fetch")
    r = np.random.default_rng(11)
    alphabet = list("ab.*?x")
    for _ in range(300):
        tool = "".join(alphabet[int(j)] for j in
                       r.integers(len(alphabet), size=int(r.integers(7))))
        assert split_tool(tool) == j_split_tool(tool), tool


def test_record_normalization_equal():
    t, jt = AgentActionTarget(), JAgentTarget()
    for rec in seeded_records(3, 120):
        assert t.review_of(rec) == jt.review_of(rec)
        a, ja = AgentAction.from_record(rec), JAgentAction.from_record(rec)
        assert a.to_record() == ja.to_record()
        handled, review = t.handle_review(a)
        j_handled, j_review = jt.handle_review(ja)
        assert handled and j_handled and review == j_review
        wrapped = {"kind": "AgentAction", "spec": rec}
        assert t.handle_review(wrapped) == jt.handle_review(wrapped)
        assert t.process_data(a) == jt.process_data(ja) if a.tool else True
        assert not t.review_autorejects(review, {})
    # K8s shapes are another target's; a skill-less record still carries
    # its context object
    assert t.handle_review({"kind": {"group": "", "kind": "Pod"}})[0] is False
    assert K8sValidationTarget().handle_review(AgentAction("a", "x"))[0] \
        is False
    _, bare = t.handle_review(AgentAction(agent="a", tool="x"))
    assert bare["_unstable"]["namespace"]["metadata"]["labels"] == {}
    assert t.process_data(SkillRecord("fs", {"signed": True})) == \
        jt.process_data(JSkillRecord("fs", {"signed": True}))


def test_handle_violation_equal():
    from gatekeeper_tpu.constraint.types import Result as JResult
    from gatekeeper_tpu_torch.constraint.types import Result

    t, jt = AgentActionTarget(), JAgentTarget()
    for rec in seeded_records(5, 20):
        r = Result(msg="m", metadata={}, constraint={},
                   review=t.review_of(rec), enforcement_action="deny")
        jr = JResult(msg="m", metadata={}, constraint={},
                     review=jt.review_of(rec), enforcement_action="deny")
        t.handle_violation(r)
        jt.handle_violation(jr)
        assert r.resource == jr.resource
        assert r.resource["apiVersion"] == AGENT_API_VERSION


def test_match_ir_equal():
    t, jt = AgentActionTarget(), JAgentTarget()
    matches = PARITY_MATCHES + seeded_matches(7, 60)
    for i, m in enumerate(matches):
        c = agent_constraint("K", f"c{i}", match=m)
        assert t.match_ir(c) == jt.match_ir(c), m


def test_validate_constraint_glob_grammar_equal():
    t, jt = AgentActionTarget(), JAgentTarget()
    globs = ["*", "shell.*", "net.fetch", "fetch", "a*b", "*.b", "a.b.*",
             ".*", "a?", "", 7, None, "ns.x.y"]
    cases = [{"tools": [g]} for g in globs] + [
        {"agents": ["x", 3]}, {"excludedAgents": ["x"]},
        {"skills": {"matchExpressions": [{"key": "k",
                                          "operator": "Bogus"}]}},
        {"capabilities": {"matchLabels": {"exec": "true"}}},
    ] + seeded_matches(9, 40)
    for m in cases:
        c = agent_constraint("K", "c", match=m)
        try:
            jt.validate_constraint(c)
            j_ok = True
        except JInvalidConstraintError:
            j_ok = False
        try:
            t.validate_constraint(c)
            ok = True
        except InvalidConstraintError:
            ok = False
        assert ok == j_ok, m
    for bad in (["a*b"], ["*.b"], ["a.b.*"], [".*"], [7]):
        with pytest.raises(InvalidConstraintError):
            t.validate_constraint(
                agent_constraint("K", "c", match={"tools": bad}))


# -- match parity: host oracle <-> K1's plain version, both packages ---------


def _port_match(constraints, reviews):
    from gatekeeper_tpu_torch.engine.matchkernel import (
        features_to_tensors,
        match_matrix,
        matchspec_to_tensors,
    )
    from gatekeeper_tpu_torch.flatten import Vocab, batch_review_features

    t = AgentActionTarget()
    vocab = Vocab()
    specs = t.compile_match_specs(constraints, vocab)
    fb = batch_review_features(
        [t.encode_review_features(r, {}, vocab) for r in reviews])
    got = match_matrix(matchspec_to_tensors(specs, "cpu"),
                       features_to_tensors(fb, "cpu")).numpy().astype(bool)
    want = np.array([[t.matches_constraint(c, r, {}) for r in reviews]
                     for c in constraints], dtype=bool)
    return got, want


def _jax_match(constraints, reviews):
    from gatekeeper_tpu.engine.matchkernel import (
        features_to_device,
        match_matrix,
        matchspec_to_device,
    )
    from gatekeeper_tpu.flatten.encoder import batch_review_features
    from gatekeeper_tpu.flatten.vocab import Vocab

    t = JAgentTarget()
    vocab = Vocab()
    specs = t.compile_match_specs(constraints, vocab)
    fb = batch_review_features(
        [t.encode_review_features(r, {}, vocab) for r in reviews])
    got = np.asarray(match_matrix(matchspec_to_device(specs),
                                  features_to_device(fb))).astype(bool)
    want = np.array([[t.matches_constraint(c, r, {}) for r in reviews]
                     for c in constraints], dtype=bool)
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_agent_match_oracle_kernel_parity_both_packages(seed):
    """The schema translation is lossless in the port as in the JAX
    package: host oracle == K1's plain version, and the port's bits equal
    the JAX package's, over the fixed battery plus seeded constraints x
    actions."""
    matches = PARITY_MATCHES + seeded_matches(100 + seed, 48)
    constraints = [agent_constraint("K", f"c{i}", match=m)
                   for i, m in enumerate(matches)]
    t = AgentActionTarget()
    reviews = [t.handle_review(AgentAction.from_record(a.to_record()))[1]
               for a in PARITY_ACTIONS]
    reviews += [t.review_of(rec) for rec in seeded_records(200 + seed, 64)]
    got, want = _port_match(constraints, reviews)
    assert (got == want).all(), np.argwhere(got != want).tolist()
    j_got, j_want = _jax_match(constraints, reviews)
    assert (j_got == j_want).all()
    assert np.array_equal(got, j_got)
    # every dimension of the battery discriminates
    assert want.any() and not want.all()
    assert want[3].any() and not want[3].all()   # shell.* glob
    assert want[8].any() and not want[8].all()   # agents
    assert want[13].any() and not want[13].all()  # skills selector


# -- client end to end -------------------------------------------------------


def _clients(port_driver):
    port = Backend(port_driver).new_client(K8sValidationTarget(),
                                           AgentActionTarget())
    ref = JBackend(JRegoDriver()).new_client(JK8sTarget(), JAgentTarget())
    return port, ref


def _add_policy(client, templates, constraints):
    for tm in templates:
        client.add_template(tm)
    for c in constraints:
        client.add_constraint(c)


def _result_rows(responses):
    out = []
    for r in responses.by_target[TARGET_NAME].results:
        out.append((r.msg, r.enforcement_action,
                    (r.constraint.get("metadata") or {}).get("name"),
                    json.dumps(r.resource, sort_keys=True)))
    return out


POLICY_TEMPLATES = [
    agent_template("AgentShellAllowlist", SHELL_REGO),
    agent_template("AgentRequireSignedSkills", SIGNED_REGO),
]


def seeded_policy(seed: int, n: int):
    """n constraints over the two templates without external data, match
    blocks drawn from the seed."""
    out = []
    for i, m in enumerate(seeded_matches(seed, n)):
        if i % 2 == 0:
            out.append(agent_constraint(
                "AgentShellAllowlist", f"shell-{i}", match=m,
                params={"allowed": COMMANDS[: 1 + i % 3]}))
        else:
            out.append(agent_constraint(
                "AgentRequireSignedSkills", f"signed-{i}", match=m))
    return out


@pytest.mark.parametrize("driver", ["torch", "rego"])
def test_agent_review_and_audit_equal(driver):
    """Reviews of seeded records and the audit over ingested actions: the
    port (TorchDriver on the CPU, and its interpreter driver) answers as
    the JAX package's interpreter."""
    drv = TorchDriver(device="cpu") if driver == "torch" else RegoDriver()
    port, ref = _clients(drv)
    constraints = seeded_policy(21, 12)
    _add_policy(port, POLICY_TEMPLATES, constraints)
    _add_policy(ref, POLICY_TEMPLATES, constraints)
    records = [r for r in seeded_records(22, 48) if r["tool"]]
    got = port.review_many([AgentAction.from_record(r) for r in records])
    want = [ref.review(JAgentAction.from_record(r)) for r in records]
    assert [_result_rows(g) for g in got] == [_result_rows(w) for w in want]
    assert sum(len(_result_rows(w)) for w in want) > 0
    for rec in records:
        port.add_data(AgentAction.from_record(rec))
        ref.add_data(JAgentAction.from_record(rec))
    port.add_data(SkillRecord(name="skill-0", labels={"signed": True}))
    ref.add_data(JSkillRecord(name="skill-0", labels={"signed": True}))
    audit = _result_rows(port.audit())
    assert audit == _result_rows(ref.audit()) and audit
    # removing every action empties both audits
    for rec in records:
        port.remove_data(AgentAction.from_record(rec))
        ref.remove_data(JAgentAction.from_record(rec))
    assert _result_rows(port.audit()) == _result_rows(ref.audit()) == []


def test_synth_agent_reviews_equal():
    from gatekeeper_tpu.integrity.canary import (
        synth_agent_reviews as j_synth,
    )
    from gatekeeper_tpu_torch.integrity.canary import synth_agent_reviews

    for seed in range(4):
        constraints = seeded_policy(300 + seed, 10)
        constraints[0]["spec"]["parameters"] = {
            "allowed": ["ls"], "domains": ["example.com"],
            "required": ["reason"]}
        for k in (1, 4, 7):
            got = synth_agent_reviews(constraints, k=k)
            assert got == j_synth(constraints, k=k)
            assert len(got) == k
    assert synth_agent_reviews([], k=2) == j_synth([], k=2)


# -- the /v1/agent/review contract at small size -----------------------------


def default_timeout_assign():
    return {
        "apiVersion": "mutations.gatekeeper.sh/v1alpha1",
        "kind": "Assign",
        "metadata": {"name": "default-timeout"},
        "spec": {
            "applyTo": [{"groups": ["shell"], "versions": ["v1"],
                         "kinds": ["exec"]}],
            "match": {"tools": ["shell.*"]},
            "location": "spec.arguments.timeoutSeconds",
            "parameters": {
                "pathTests": [{"subPath": "spec.arguments.timeoutSeconds",
                               "condition": "MustNotExist"}],
                "assign": {"value": 30},
            },
        },
    }


CONTRACT_TEMPLATES = [
    agent_template("AgentShellAllowlist", SHELL_REGO),
    agent_template("AgentRequireSignedSkills", SIGNED_REGO),
    agent_template("AgentVerifiedSkills", VERIFIED_REGO),
]
CONTRACT_CONSTRAINTS = [
    agent_constraint("AgentShellAllowlist", "shell-allowlist",
                     match={"tools": ["shell.*"]},
                     params={"allowed": ["ls", "cat"]}),
    agent_constraint("AgentRequireSignedSkills", "signed",
                     match={"tools": ["*"]}),
    agent_constraint("AgentVerifiedSkills", "verified",
                     match={"tools": ["*"]}),
]


def contract_requests(seed: int, n: int, mixed: bool):
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bad = mixed and r.random() < 0.5
        out.append({
            "uid": f"call-{seed}-{i}",
            "id": f"call-{seed}-{i}",
            "agent": f"planner-{int(r.integers(4))}",
            "session": "s-1",
            "tool": ["shell.exec", "net.fetch"][int(r.integers(2))]
            if mixed else "shell.exec",
            "arguments": {"command": ["ls", "rm"][int(bad)]},
            "capabilities": ["exec"],
            "skill": {"name": "fs-tools", "publisher": "acme",
                      "signed": not (mixed and r.random() < 0.3),
                      "digest": "bad-1" if mixed and r.random() < 0.3
                      else "sha256:abc"},
        })
    return out


def _post_all(port: int, requests):
    """POST every request at once (one barrier) -> bodies by uid."""
    url = f"http://127.0.0.1:{port}/v1/agent/review"
    barrier = threading.Barrier(len(requests))
    out, errors = {}, []

    def post(req):
        body = json.dumps({"apiVersion": AGENT_API_VERSION,
                           "kind": "AgentActionReview",
                           "request": req}).encode()
        try:
            barrier.wait(timeout=10)
            with urllib.request.urlopen(url, data=body, timeout=60) as f:
                out[req["uid"]] = json.loads(f.read())
        except Exception as e:  # surfaced by the assert below
            errors.append((req["uid"], repr(e)))

    threads = [threading.Thread(target=post, args=(q,)) for q in requests]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=90)
    assert not errors, errors
    return out


def _contract_planes(stub_provider):
    from gatekeeper_tpu.externaldata import (
        ExternalDataSystem as JExternalDataSystem,
    )
    from gatekeeper_tpu.mutation.system import (
        MutationSystem as JMutationSystem,
    )
    from gatekeeper_tpu.webhook.server import (
        WebhookServer as JWebhookServer,
    )
    from gatekeeper_tpu_torch.externaldata import ExternalDataSystem
    from gatekeeper_tpu_torch.mutation.system import MutationSystem
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    drv = TorchDriver(device="cpu")
    port, ref = _clients(drv)
    for client, system in ((port, ExternalDataSystem()),
                           (ref, JExternalDataSystem())):
        system.upsert(stub_provider.provider_obj(name="skill-registry"))
        client.set_external_data(system)
        _add_policy(client, CONTRACT_TEMPLATES, CONTRACT_CONSTRAINTS)
    mut = MutationSystem(target_handler=AgentActionTarget(), device="cpu")
    j_mut = JMutationSystem(target_handler=JAgentTarget())
    mut.upsert(default_timeout_assign())
    j_mut.upsert(default_timeout_assign())
    server = WebhookServer(port, K8S_TARGET, window_ms=150.0,
                           agent_review=True, agent_mutation_system=mut)
    j_server = JWebhookServer(ref, K8S_TARGET, window_ms=150.0,
                              agent_review=True, agent_mutation_system=j_mut)
    return drv, port, mut, server, j_server


def test_agent_review_contract_small(stub_provider):
    """24 concurrent /v1/agent/review requests, 3 agent templates (one
    external_data) and the default-timeout Assign: one fused dispatch per
    micro-batch, one K1 mutation screen, no interpreter render and no
    provider fetch on the cache-hit path, and every body equal to the JAX
    package's WebhookServer's (its interpreter driver)."""
    drv, port, mut, server, j_server = _contract_planes(stub_provider)
    dispatches = []
    need_all = drv.kernel.dispatch_need_all

    def counted(*a, **kw):
        dispatches.append(1)
        return need_all(*a, **kw)

    drv.kernel.dispatch_need_all = counted
    allowed = contract_requests(31, 24, mixed=False)
    mixed = contract_requests(32, 24, mixed=True)

    def mutated(req):
        return AgentAction.from_record(dict(
            req, arguments=dict(req["arguments"], timeoutSeconds=30)
            if req["tool"].startswith("shell.") else req["arguments"]))

    # stage the policy for both shapes and prime the provider cache, so
    # the HTTP batches are cache hits
    assert port.warm_review_path([mutated(q) for q in allowed])
    port.review_many([mutated(q) for q in allowed + mixed])
    server.start()
    j_server.start()
    try:
        fetches0 = stub_provider.fetch_count
        screens0 = mut.screen_dispatches
        del dispatches[:]
        got = _post_all(server.port, allowed)
        assert server.agent_batcher.batches_dispatched == 1
        assert server.agent_batcher.requests_batched == 24
        assert server.agent_mutate_batcher.batches_dispatched == 1
        assert mut.screen_dispatches == screens0 + 1
        assert len(dispatches) == 1
        assert drv.stats["interp_rendered_pairs"] == 0
        assert drv.stats["compiled_pairs"] == 24 * 3
        assert drv.stats["n_reviews"] == 24
        assert stub_provider.fetch_count == fetches0
        for body in got.values():
            resp = body["response"]
            assert resp["allowed"] is True, resp
            ops = json.loads(base64.b64decode(resp["patch"]))
            assert {"op": "add", "path": "/spec/arguments/timeoutSeconds",
                    "value": 30} in ops
        assert got == _post_all(j_server.port, allowed)
        # a mixed round: denials of each template, verdicts and patches
        # equal to the JAX package's, one more fused dispatch per batch
        batches0 = server.agent_batcher.batches_dispatched
        got = _post_all(server.port, mixed)
        assert len(dispatches) - 1 == \
            server.agent_batcher.batches_dispatched - batches0
        want = _post_all(j_server.port, mixed)
        assert got == want
        verdicts = [b["response"]["allowed"] for b in got.values()]
        assert any(verdicts) and not all(verdicts)
        text = " ".join(b["response"].get("status", {}).get("message", "")
                        for b in got.values())
        for name in ("shell-allowlist", "signed", "verified"):
            assert f"[denied by {name}]" in text
    finally:
        server.stop()
        j_server.stop()


def test_agent_plane_404_when_off_and_sched_snapshot():
    from gatekeeper_tpu_torch.webhook.server import WebhookServer

    client = Backend(RegoDriver()).new_client(K8sValidationTarget(),
                                              AgentActionTarget())
    off = WebhookServer(client, K8S_TARGET, window_ms=1.0)
    on = WebhookServer(client, K8S_TARGET, window_ms=1.0, agent_review=True)
    assert off.agent_handler is None and off.review_targets() == [K8S_TARGET]
    assert on.review_targets() == [K8S_TARGET, TARGET_NAME]
    assert set(on.sched_snapshot()) == {"validation", "agent"}
    off.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{off.port}/v1/agent/review",
            data=json.dumps({"request": {"agent": "a",
                                         "tool": "x"}}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404
        assert json.loads(e.value.read()) == {
            "error": "agent review not enabled"}
    finally:
        off.stop()


def test_agent_handler_rejects_incomplete_records():
    client = Backend(RegoDriver()).new_client(K8sValidationTarget(),
                                              AgentActionTarget())
    batcher, mb, handler = make_agent_plane(client, window_ms=1.0)
    assert mb is None
    assert handler.handle({"agent": "a"}).code == 422
    assert handler.handle({"tool": "x"}).code == 422


# -- the standing divergence: a failed fused agent batch ---------------------


def _fail_policy_case(pkg, policy):
    if pkg == "port":
        from gatekeeper_tpu_torch.faults import FAULTS
        from gatekeeper_tpu_torch.webhook.server import WebhookServer

        client = Backend(TorchDriver(device="cpu")).new_client(
            K8sValidationTarget(), AgentActionTarget())
    else:
        from gatekeeper_tpu.faults import FAULTS
        from gatekeeper_tpu.webhook.server import WebhookServer

        client = JBackend(JRegoDriver()).new_client(JK8sTarget(),
                                                    JAgentTarget())
    _add_policy(client, POLICY_TEMPLATES[:1], [agent_constraint(
        "AgentShellAllowlist", "shell-allowlist",
        match={"tools": ["shell.*"]}, params={"allowed": ["ls"]})])
    server = WebhookServer(client, K8S_TARGET, window_ms=1.0,
                           agent_review=True, fail_policy=policy)
    server.start()
    FAULTS.arm("webhook.batch_dispatch", "error", message="device fault")
    try:
        resp = server.agent_handler.handle({
            "agent": "planner-1", "tool": "shell.exec",
            "arguments": {"command": "rm"}})
    finally:
        FAULTS.disarm("webhook.batch_dispatch")
        server.stop()
    return resp, server.agent_batcher.batch_failures


@pytest.mark.parametrize("policy", ["open", "closed"])
def test_failed_agent_batch_answers_fail_policy_never_host(policy):
    """Standing divergence: the port answers a fused agent batch that
    failed with the endpoint's fail policy; the JAX package answers it on
    its host interpreter (the allowlist's denial)."""
    resp, failures = _fail_policy_case("port", policy)
    assert failures == 1
    assert resp.allowed is (policy == "open")
    assert "device fault" in resp.message
    if policy == "closed":
        assert resp.code == 503
    j_resp, _ = _fail_policy_case("jax", policy)
    assert j_resp.allowed is False and j_resp.code == 403
    assert "outside the allowlist" in j_resp.message


# -- the genericity gate -----------------------------------------------------

_GATE_TOKENS = {"apiGroups", "namespaceSelector", "excludedNamespaces"}
_GATE_NAMES = {"AdmissionRequest", "AugmentedReview", "AugmentedUnstructured"}
# the JAX package's allowed boundary (tests/test_agentaction.py), minus
# soak/harness.py, which the port does not have yet, plus entry.py: the
# harness step's own Gateway-join constraints (the port's copy of
# __graft_entry__.entry, which lies outside the JAX package), a client of
# the K8s target's public schema as the soak harness is
_GATE_ALLOWED = {
    "constraint/target.py",
    "constraint/handler.py",
    "constraint/__init__.py",
    "constraint/match.py",
    "engine/matchspec.py",
    "agentaction/target.py",
    "control/process.py",
    "analysis/corpus.py",
    "entry.py",
}
_SEMANTICS_MODULES = {"match", "matchspec", "target"}
# plus kernels/ops.py: K1's wrapper, the port's half of
# engine/matchkernel.py, reads the spec compiler's op and scope codes
_IMPORT_ALLOWED = _GATE_ALLOWED | {
    "kernels/ops.py",
    "engine/__init__.py",
    "engine/matchkernel.py",
    "flatten/encoder.py",
    "agentaction/__init__.py",
    "agentaction/review.py",
}


def _pkg_modules():
    for root, _dirs, files in os.walk(PKG):
        for fn in sorted(files):
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                yield os.path.relpath(path, PKG).replace(os.sep, "/"), path


def _code_strings(tree):
    """String constants excluding docstrings (bare-Expr strings)."""
    doc_ids = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list):
            for stmt in body:
                if (isinstance(stmt, ast.Expr)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, str)):
                    doc_ids.add(id(stmt.value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in doc_ids):
            yield node.value


def test_genericity_gate_no_k8s_fields_outside_targets():
    """No port module outside the target boundary references the
    target-specific review/match vocabulary."""
    offenders = []
    for rel, path in _pkg_modules():
        if rel in _GATE_ALLOWED:
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        hits = set()
        for s in _code_strings(tree):
            hits.update(t for t in _GATE_TOKENS if t in s.split())
            hits.update(t for t in _GATE_TOKENS if s == t)
        for node in ast.walk(tree):
            if isinstance(node, ast.Name) and node.id in _GATE_NAMES:
                hits.add(node.id)
            elif isinstance(node, ast.Attribute) and node.attr in _GATE_NAMES:
                hits.add(node.attr)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    if alias.name in _GATE_NAMES:
                        hits.add(alias.name)
        if hits:
            offenders.append((rel, sorted(hits)))
    assert not offenders, offenders


def test_genericity_gate_semantics_imports_confined():
    """The match-semantics modules are imported only by the target
    boundary and the engine's own internals."""
    offenders = []
    for rel, path in _pkg_modules():
        if rel in _IMPORT_ALLOWED:
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                leaf = mod.rsplit(".", 1)[-1]
                if leaf in _SEMANTICS_MODULES:
                    offenders.append((rel, f"from {mod} import ..."))
                elif leaf in ("constraint", "engine") or mod == "":
                    for alias in node.names:
                        if alias.name in _SEMANTICS_MODULES:
                            offenders.append(
                                (rel, f"from {mod} import {alias.name}"))
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    leaf = alias.name.rsplit(".", 1)[-1]
                    if leaf in _SEMANTICS_MODULES:
                        offenders.append((rel, f"import {alias.name}"))
    assert not offenders, offenders
