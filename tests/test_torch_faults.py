"""The port's fault registry (gatekeeper_tpu_torch/faults/injection.py) on
the CPU, held against the JAX package's: GATEKEEPER_TPU_FAULTS arming
(`configure_from_env`) over one table of strings, malformed entries
included; the clock-jump skew's after/count semantics; the MicroBatcher's
skewed deadline clock shedding a queued request on a `webhook.clock`
jump, as tests/test_chaos.py does for the JAX batcher; arming at import in
a fresh interpreter; and the driver's `driver.device_dispatch` point on
the port's fused path."""

import dataclasses
import os
import subprocess
import sys

import pytest

import gatekeeper_tpu.faults as j_faults
import gatekeeper_tpu.metrics as j_metrics
import gatekeeper_tpu.webhook.server as j_server
import gatekeeper_tpu_torch.faults as t_faults
import gatekeeper_tpu_torch.metrics as t_metrics
import gatekeeper_tpu_torch.webhook.server as t_server
from gatekeeper_tpu.constraint import Backend as JBackend
from gatekeeper_tpu.constraint import K8sValidationTarget as JTarget
from gatekeeper_tpu.constraint import TpuDriver
from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver

pytestmark = pytest.mark.chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = "admission.k8s.gatekeeper.sh"

REQ_LABELS = """package reqlabels

violation[{"msg": msg}] {
    required := {key | key := input.parameters.labels[_]}
    provided := {key | input.review.object.metadata.labels[key]}
    missing := required - provided
    count(missing) > 0
    msg := sprintf("missing: %v", [missing])
}
"""


@pytest.fixture(autouse=True)
def _reset_faults():
    j_faults.FAULTS.reset()
    t_faults.FAULTS.reset()
    yield
    j_faults.FAULTS.reset()
    t_faults.FAULTS.reset()


def _specs(reg):
    """Every armed point's spec as a plain dict, by point."""
    return {
        point: dataclasses.asdict(reg.spec(point))
        for point in sorted(reg._specs)
    }


# one string per case: well-formed entries, device-labelled points whose
# names hold '=', every modifier, and the malformed entries the grammar
# skips (no '=', an unknown mode, an unknown modifier, a bad number)
ENV_TABLE = [
    "",
    " , ,",
    "driver.device_dispatch=error:count=5,"
    "bridge.process=hang:delay=0.25,"
    "nonsense,bad=notamode,x=error:count=zzz,"
    "webhook.clock=clock_jump:delay=3600:after=2",
    "driver.device_dispatch[device=1]=error:after=3:count=2",
    "driver.device_dispatch=error:count=3:after=40,"
    "webhook.batch_dispatch=hang:delay=0.5:message=slow disk",
    "integrity.canary[device=0]=error:message=sdc,"
    "externaldata.fetch=error:retries=3,"
    "compile.swap=error:delay=abc,"
    "audit.barrier=clock_jump",
    "p=error,p=hang:delay=1.5",
    "=error,q=,r=error:count=",
    "s = error : count=2",
]


@pytest.mark.parametrize("env", ENV_TABLE)
def test_configure_from_env_arms_as_jax(env):
    """The same string arms the same number of points with the same specs
    in both packages' registries."""
    out = {}
    for name, f in (("jax", j_faults), ("torch", t_faults)):
        reg = f.FaultRegistry()
        armed = f.configure_from_env(reg, env=env)
        out[name] = (armed, _specs(reg), reg.active())
    assert out["torch"] == out["jax"]


def test_configure_from_env_reads_the_environment(monkeypatch):
    """Without an `env` argument the variable is read; the table's mixed
    case arms its three well-formed entries."""
    monkeypatch.setenv("GATEKEEPER_TPU_FAULTS", ENV_TABLE[2])
    reg = t_faults.FaultRegistry()
    assert t_faults.configure_from_env(reg) == 3
    assert reg.spec("driver.device_dispatch").count == 5
    assert reg.spec("bridge.process").delay_s == 0.25
    assert reg.spec("webhook.clock").after == 2
    assert reg.spec("bad") is None and reg.spec("x") is None


# (arm kwargs, how many consultations)
SKEW_CASES = [
    ({"mode": "clock_jump", "delay_s": 60.0, "after": 1}, 4),
    ({"mode": "clock_jump", "delay_s": 3600.0, "after": 2, "count": 2}, 6),
    ({"mode": "clock_jump", "delay_s": 5.0, "count": 0}, 3),
    ({"mode": "clock_jump", "delay_s": -30.0}, 3),
    ({"mode": "error", "delay_s": 60.0}, 2),
    ({"mode": "hang", "delay_s": 0.0}, 2),
]


@pytest.mark.parametrize("kw,n", SKEW_CASES)
def test_skew_honors_after_and_count_as_jax(kw, n):
    """`skew` consults only a clock_jump spec, counts every consultation
    as a hit, skips the first `after` and fires at most `count` times; the
    sequence, hits and fired counts equal the JAX registry's."""
    out = {}
    for name, f in (("jax", j_faults), ("torch", t_faults)):
        reg = f.FaultRegistry()
        reg.arm("c", **kw)
        seq = [reg.skew("c") for _ in range(n)] + [reg.skew("other")]
        out[name] = (seq, reg.hits("c"), reg.fired("c"))
    assert out["torch"] == out["jax"]


def test_skew_clock_jump_semantics():
    """tests/test_chaos.py's case on the port's registry: no offset before
    the jump, the offset at the triggering consultation."""
    reg = t_faults.FaultRegistry()
    reg.arm("c", mode="clock_jump", delay_s=60.0, after=1)
    assert reg.skew("c") == 0.0
    assert reg.skew("c") == 60.0
    assert reg.skew("other") == 0.0
    assert reg.fired("c") == 1
    # the module-level skew reads the process registry
    t_faults.FAULTS.arm("webhook.clock", mode="clock_jump", delay_s=7.0)
    assert t_faults.skew("webhook.clock") == 7.0


def _add_policy(cl):
    cl.add_template({
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "reqlabels"},
        "spec": {
            "crd": {"spec": {"names": {"kind": "ReqLabels"}}},
            "targets": [{"target": TARGET, "rego": REQ_LABELS}],
        },
    })
    cl.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "ReqLabels",
        "metadata": {"name": "need-owner"},
        "spec": {"parameters": {"labels": ["owner"]}},
    })
    return cl


def admission_request(i=0, labels=None):
    obj = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"p{i}",
            "namespace": "default",
            **({"labels": labels} if labels else {}),
        },
        "spec": {"containers": [{"name": "c", "image": "nginx"}]},
    }
    return {
        "uid": f"u{i}",
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "operation": "CREATE",
        "name": f"p{i}",
        "namespace": "default",
        "userInfo": {"username": "alice"},
        "object": obj,
    }


def _counter(metrics, name, **tags):
    snap = metrics.snapshot()["counters"]
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
    return snap.get(f"{name}{{{inner}}}", 0)


def _stack(client, metrics_mod, server):
    metrics = metrics_mod.MetricsRegistry()
    batcher = server.MicroBatcher(client, TARGET, window_ms=1.0,
                                  metrics=metrics, max_queue=64)
    handler = server.BatchedValidationHandler(
        batcher, request_timeout=5.0, metrics=metrics, fail_policy="open")
    return metrics, batcher, handler


def test_clock_jump_expires_queued_request_as_jax():
    """A clock jump armed to land after the deadline is computed (after=1):
    the next deadline check sees the request expired and sheds it with
    the fail-open envelope before any dispatch, in both batchers."""
    out = {}
    for name, client, f, m, srv in (
        ("jax", _add_policy(JBackend(TpuDriver(use_jax=False)).new_client(
            JTarget())), j_faults, j_metrics, j_server),
        ("torch", _add_policy(Backend(TorchDriver(device="cpu")).new_client(
            K8sValidationTarget())), t_faults, t_metrics, t_server),
    ):
        metrics, batcher, handler = _stack(client, m, srv)
        f.FAULTS.arm("webhook.clock", mode="clock_jump", delay_s=3600.0,
                     after=1)
        batcher.start()
        try:
            resp = handler.handle(admission_request(0))
        finally:
            batcher.stop()
        out[name] = {
            "allowed": resp.allowed,
            "deadline": "deadline" in resp.message,
            "dispatched": batcher.batches_dispatched,
            "jumped": f.FAULTS.fired("webhook.clock") >= 1,
            "shed": _counter(metrics, "webhook_shed_total",
                             plane="validation", reason="deadline"),
        }
        f.FAULTS.reset()
    assert out["torch"] == out["jax"]
    assert out["torch"] == {"allowed": True, "deadline": True,
                            "dispatched": 0, "jumped": True, "shed": 1}


def test_env_arming_at_import_in_a_fresh_interpreter():
    """GATEKEEPER_TPU_FAULTS arms the port's process registry when
    gatekeeper_tpu_torch.faults is first imported, as a second replica
    started with it in its environment needs; nothing of JAX loads."""
    code = (
        "import json, sys\n"
        "from gatekeeper_tpu_torch.faults import FAULTS\n"
        "s = FAULTS.spec('driver.device_dispatch')\n"
        "print(json.dumps([s.mode, s.after, s.count, FAULTS.active(),\n"
        "    sorted(k for k in sys.modules\n"
        "           if k.split('.')[0] in ('jax', 'gatekeeper_tpu'))]))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, GATEKEEPER_TPU_FAULTS=(
        "driver.device_dispatch=error:after=40:count=3,bogus"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        '["error", 40, 3, true, []]'


def test_driver_dispatch_point_fails_the_fused_batch():
    """`driver.device_dispatch` sits in TorchDriver's fused need dispatch:
    armed with after=1, count=3, the first batch is served, the next three
    fail and get the fail policy, the breaker opens at its threshold and
    turns the fifth batch away without a dispatch; an audit sweep passes
    the same point."""
    client = _add_policy(Backend(TorchDriver(device="cpu")).new_client(
        K8sValidationTarget()))
    metrics, batcher, handler = _stack(client, t_metrics, t_server)
    t_faults.FAULTS.arm("driver.device_dispatch", mode="error", after=1,
                        count=3)
    batcher.start()
    try:
        answers = [handler.handle(admission_request(i)) for i in range(5)]
    finally:
        batcher.stop()
    assert [(a.allowed, a.code) for a in answers] == [
        (False, 403), (True, 200), (True, 200), (True, 200), (True, 200)]
    assert "need-owner" in answers[0].message
    assert t_faults.FAULTS.hits("driver.device_dispatch") == 4
    assert t_faults.FAULTS.fired("driver.device_dispatch") == 3
    assert batcher.batch_failures == 3 and batcher.breaker.state == "open"
    assert _counter(metrics, "webhook_degraded_dispatch_total",
                    plane="validation") == 1
    t_faults.FAULTS.reset()
    client.add_data(admission_request(9)["object"])
    assert len(client.audit().results()) == 1
    t_faults.FAULTS.arm("driver.device_dispatch", mode="error")
    with pytest.raises(t_faults.FaultError):
        client.audit()
