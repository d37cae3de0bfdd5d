"""The port stands alone: gatekeeper_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, and the port's entry points run on the
card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gatekeeper_tpu_torch")


def _modules():
    out = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gatekeeper_tpu")


def test_import_pulls_in_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest),
    importing every module of the port loads no jax* and no
    gatekeeper_tpu.* module."""
    mods = _modules()
    assert len(mods) > 30
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'gatekeeper_tpu'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


AUDIT_PLANE = (
    "gatekeeper_tpu_torch.audit",
    "gatekeeper_tpu_torch.audit.manager",
    "gatekeeper_tpu_torch.control",
    "gatekeeper_tpu_torch.control.events",
    "gatekeeper_tpu_torch.control.process",
    "gatekeeper_tpu_torch.obs",
    "gatekeeper_tpu_torch.obs.tracer",
    "gatekeeper_tpu_torch.faults",
    "gatekeeper_tpu_torch.faults.injection",
    "gatekeeper_tpu_torch.logs",
)


def test_audit_plane_imports_with_jax_blocked():
    """The audit controller's subpackages import, and a from-cache sweep
    runs on the CPU, in an interpreter where importing jax or the JAX
    package fails."""
    assert set(AUDIT_PLANE) <= set(_modules())
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {AUDIT_PLANE!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from gatekeeper_tpu_torch.audit import AuditManager\n"
        "from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver\n"
        "c = chip_smoke.build_client(TorchDriver(device='cpu'), 30, 8)\n"
        "r = AuditManager(c, chip_smoke.TARGET).audit()\n"
        "print(r.total_violations)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) > 0


ADMISSION_PLANE = (
    "gatekeeper_tpu_torch.webhook",
    "gatekeeper_tpu_torch.webhook.policy",
    "gatekeeper_tpu_torch.webhook.namespacelabel",
    "gatekeeper_tpu_torch.webhook.server",
    "gatekeeper_tpu_torch.metrics",
    "gatekeeper_tpu_torch.metrics.registry",
    "gatekeeper_tpu_torch.faults",
    "gatekeeper_tpu_torch.faults.breaker",
    "gatekeeper_tpu_torch.faults.errors",
    "gatekeeper_tpu_torch.native",
)


def test_admission_plane_imports_with_jax_blocked():
    """The webhook, metrics, faults and native subpackages import, the
    native flattener builds and encodes, and a WebhookServer answers an
    AdmissionReview over HTTP on the CPU, in an interpreter where
    importing jax or the JAX package fails."""
    assert set(ADMISSION_PLANE) <= set(_modules())
    code = (
        "import importlib, json, sys, urllib.request\n"
        "for m in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {ADMISSION_PLANE!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from gatekeeper_tpu_torch.native import load_flatten_native\n"
        "from gatekeeper_tpu_torch.webhook import WebhookServer\n"
        "from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver\n"
        "assert hasattr(load_flatten_native(), 'encode_rows')\n"
        "c = chip_smoke.build_client(TorchDriver(device='cpu'), 30, 8)\n"
        "s = WebhookServer(c, chip_smoke.TARGET)\n"
        "s.start()\n"
        "pod = chip_smoke.make_pod(503)\n"
        "req = {'uid': 'u', 'operation': 'CREATE', 'object': pod,\n"
        "       'kind': {'group': '', 'version': 'v1', 'kind': 'Pod'},\n"
        "       'userInfo': {'username': 'u'}}\n"
        "body = json.dumps({'request': req}).encode()\n"
        "url = f'http://127.0.0.1:{s.port}/v1/admit'\n"
        "out = json.loads(urllib.request.urlopen(url, body, timeout=60).read())\n"
        "s.stop()\n"
        "print(out['response']['allowed'], s.batcher.batches_dispatched)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "1"]


SERVING_PLANE = (
    "gatekeeper_tpu_torch.sched",
    "gatekeeper_tpu_torch.sched.scheduler",
    "gatekeeper_tpu_torch.ingest",
    "gatekeeper_tpu_torch.ingest.transport",
    "gatekeeper_tpu_torch.ingest.decode",
    "gatekeeper_tpu_torch.ingest.server",
    "gatekeeper_tpu_torch.obs.decisionlog",
    "gatekeeper_tpu_torch.obs.slo",
    "gatekeeper_tpu_torch.webhook.bridge",
)


def test_serving_planes_run_with_jax_blocked(tmp_path):
    """The scheduler, the framed ingest plane, the decision log, the SLO
    engine and the native front import, and a WebhookServer under the
    deadline policy answers a framed AdmissionReview and a BridgeStack an
    HTTP one through the C++ front, on the CPU, in an interpreter where
    importing jax or the JAX package fails."""
    assert set(SERVING_PLANE) <= set(_modules())
    code = (
        "import importlib, json, sys, urllib.request\n"
        "for m in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {SERVING_PLANE!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver\n"
        "from gatekeeper_tpu_torch.ingest import PLANE_VALIDATE, StreamClient\n"
        "from gatekeeper_tpu_torch.obs import DecisionLog, SloEngine\n"
        "from gatekeeper_tpu_torch.webhook import WebhookServer\n"
        "from gatekeeper_tpu_torch.webhook.bridge import BridgeStack\n"
        "c = chip_smoke.build_client(TorchDriver(device='cpu'), 30, 8)\n"
        "slo = SloEngine()\n"
        "s = WebhookServer(c, chip_smoke.TARGET, ingest=True, slo=slo,\n"
        "                  sched_policy='deadline',\n"
        "                  decision_log=DecisionLog(slo=slo))\n"
        "s.start()\n"
        "req = chip_smoke.admission_request(chip_smoke.make_pod(503), 'u')\n"
        "body = chip_smoke._envelope(req)\n"
        "with StreamClient('127.0.0.1', s.ingest.port) as sc:\n"
        "    st, framed = sc.request(body, PLANE_VALIDATE, budget_ms=60000)\n"
        "s.stop()\n"
        f"b = BridgeStack(c, chip_smoke.TARGET, {str(tmp_path / 'i.sock')!r},\n"
        "                deadline_ms=60000)\n"
        "b.start()\n"
        "try:\n"
        "    url = f'http://127.0.0.1:{b.port}/v1/admit'\n"
        "    bridged = json.loads(urllib.request.urlopen(url, body,\n"
        "                                                timeout=60).read())\n"
        "finally:\n"
        "    b.stop()\n"
        "print(st, json.loads(framed)['response']['allowed'],\n"
        "      bridged['response']['allowed'], s.batcher.batches_dispatched,\n"
        "      b.batcher.batches_dispatched, slo.observed)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["200", "False", "False", "1", "1", "1"]


DRIVER_PLANES = (
    "gatekeeper_tpu_torch.analysis",
    "gatekeeper_tpu_torch.analysis.analyzer",
    "gatekeeper_tpu_torch.analysis.ir",
    "gatekeeper_tpu_torch.analysis.report",
    "gatekeeper_tpu_torch.integrity",
    "gatekeeper_tpu_torch.integrity.canary",
    "gatekeeper_tpu_torch.integrity.plane",
    "gatekeeper_tpu_torch.parallel.partition",
    "gatekeeper_tpu_torch.obs.attribution",
)


def test_driver_planes_run_with_jax_blocked():
    """The analyzer, the integrity plane, the partition plane and the cost
    attributor import, and a partitioned WebhookServer with canaries and
    attribution answers an AdmissionReview on the CPU, in an interpreter
    where importing jax or the JAX package fails."""
    assert set(DRIVER_PLANES) <= set(_modules())
    code = (
        "import json, importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {DRIVER_PLANES!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from gatekeeper_tpu_torch.analysis import analyze_template\n"
        "from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver\n"
        "from gatekeeper_tpu_torch.integrity import IntegrityPlane\n"
        "from gatekeeper_tpu_torch.obs import CostAttributor\n"
        "from gatekeeper_tpu_torch.webhook import WebhookServer\n"
        "v = {analyze_template(t).verdict for t in chip_smoke.template_docs()}\n"
        "drv = TorchDriver(device='cpu')\n"
        "c = chip_smoke.build_client(drv, 30, 8)\n"
        "att, integ = CostAttributor(), IntegrityPlane()\n"
        "s = WebhookServer(c, chip_smoke.TARGET, partitions=2,\n"
        "                  attributor=att, integrity=integ)\n"
        "s.start()\n"
        "req = chip_smoke.admission_request(chip_smoke.make_pod(503), 'u')\n"
        "(body,), _, _ = chip_smoke._drive_http(\n"
        "    s.port, [('/v1/admit', chip_smoke._envelope(req))], 1)\n"
        "s.stop()\n"
        "print(sorted(v), body['response']['allowed'],\n"
        "      s.partitioner.snapshot()['dispatches']['fused'],\n"
        "      integ.snapshot()['canary']['rows'] > 0, att.dispatches > 0,\n"
        "      drv.columns_skipped_static > 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "['VECTORIZED']", "False", "2", "True", "True", "True"
    ]


PROCESS_PLANES = (
    "gatekeeper_tpu_torch.externaldata",
    "gatekeeper_tpu_torch.externaldata.binding",
    "gatekeeper_tpu_torch.externaldata.cache",
    "gatekeeper_tpu_torch.externaldata.extract",
    "gatekeeper_tpu_torch.externaldata.lint",
    "gatekeeper_tpu_torch.externaldata.provider",
    "gatekeeper_tpu_torch.externaldata.system",
    "gatekeeper_tpu_torch.control.controllers",
    "gatekeeper_tpu_torch.control.kubecluster",
    "gatekeeper_tpu_torch.control.readiness",
    "gatekeeper_tpu_torch.control.runner",
    "gatekeeper_tpu_torch.control.status",
    "gatekeeper_tpu_torch.control.upgrade",
    "gatekeeper_tpu_torch.control.watch",
    "gatekeeper_tpu_torch.webhook.certs",
    "gatekeeper_tpu_torch.run",
)


def test_process_planes_run_with_jax_blocked(tmp_path):
    """The external-data plane, the control plane, the webhook's
    certificates and the process entry import, and a Runner over the
    FakeCluster (TLS on, a Provider CR and an external-data template
    ingested through the controllers) audits and answers an HTTPS
    AdmissionReview on the CPU, in an interpreter where importing jax or
    the JAX package fails."""
    assert set(PROCESS_PLANES) <= set(_modules())
    code = (
        "import importlib, json, ssl, sys, urllib.request\n"
        "for m in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {PROCESS_PLANES!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget\n"
        "from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver\n"
        "from gatekeeper_tpu_torch.control import FakeCluster, Runner\n"
        "class Fetcher:\n"
        "    def fetch(self, provider, keys):\n"
        "        return [{'key': k, 'error': 'unsigned'} if 'bad' in k\n"
        "                else {'key': k, 'value': 'ok'} for k in keys], ''\n"
        "rego = ('package ext\\nviolation[{\"msg\": m}] {\\n'\n"
        "        ' imgs := [i | i := input.review.object.spec.containers[_].image]\\n'\n"
        "        ' r := external_data({\"provider\": \"sig\", \"keys\": imgs})\\n'\n"
        "        ' count(r.errors) > 0\\n m := sprintf(\"%v\", [r.errors])\\n}\\n')\n"
        "c = FakeCluster()\n"
        "c.apply({'apiVersion': 'externaldata.gatekeeper.sh/v1alpha1',\n"
        "         'kind': 'Provider', 'metadata': {'name': 'sig'},\n"
        "         'spec': {'url': 'http://127.0.0.1:9/x', 'timeout': 1}})\n"
        "c.apply({'apiVersion': 'templates.gatekeeper.sh/v1beta1',\n"
        "         'kind': 'ConstraintTemplate', 'metadata': {'name': 'k8sext'},\n"
        "         'spec': {'crd': {'spec': {'names': {'kind': 'K8sExt'}}},\n"
        "                  'targets': [{'target': chip_smoke.TARGET, 'rego': rego}]}})\n"
        "c.apply({'apiVersion': 'constraints.gatekeeper.sh/v1beta1',\n"
        "         'kind': 'K8sExt', 'metadata': {'name': 'sig'}, 'spec': {}})\n"
        "c.apply({'apiVersion': 'config.gatekeeper.sh/v1alpha1', 'kind': 'Config',\n"
        "         'metadata': {'name': 'config', 'namespace': 'gatekeeper-system'},\n"
        "         'spec': {'sync': {'syncOnly': [{'group': '', 'version': 'v1',\n"
        "                                         'kind': 'Pod'}]}}})\n"
        "for i in range(6):\n"
        "    p = chip_smoke.make_pod(i)\n"
        "    p['spec']['containers'] = [{'name': 'c', 'image': 'bad' if i % 3 == 0 else 'ok'}]\n"
        "    c.apply(p)\n"
        "client = Backend(TorchDriver(device='cpu')).new_client(K8sValidationTarget())\n"
        f"r = Runner(c, client, chip_smoke.TARGET, webhook_tls=True, cert_dir={str(tmp_path)!r},\n"
        "           audit_interval=3600.0)\n"
        "r.external_data.fetcher = Fetcher()\n"
        "try:\n"
        "    r.start()\n"
        "    assert r.wait_ready(60)\n"
        "    n = r.audit.audit().total_violations\n"
        "    p = chip_smoke.make_pod(99)\n"
        "    p['spec']['containers'] = [{'name': 'c', 'image': 'bad:1'}]\n"
        "    req = chip_smoke.admission_request(p, 'u')\n"
        "    ctx = ssl.create_default_context(cafile=r.webhook.rotator.ca_path)\n"
        "    ctx.check_hostname = False\n"
        "    url = f'https://127.0.0.1:{r.webhook.port}/v1/admit'\n"
        "    out = json.loads(urllib.request.urlopen(\n"
        "        url, chip_smoke._envelope(req), timeout=60, context=ctx).read())\n"
        "finally:\n"
        "    r.stop()\n"
        "print(n, out['response']['allowed'], r.external_data.fetch_count)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "False", "2"]


MUTATION_PLANE = (
    "gatekeeper_tpu_torch.mutation",
    "gatekeeper_tpu_torch.mutation.lint",
    "gatekeeper_tpu_torch.mutation.mutators",
    "gatekeeper_tpu_torch.mutation.patch",
    "gatekeeper_tpu_torch.mutation.path",
    "gatekeeper_tpu_torch.mutation.system",
    "gatekeeper_tpu_torch.webhook.mutate",
    "gatekeeper_tpu_torch.analysis.corpus",
    "gatekeeper_tpu_torch.integrity.oracle",
)


def test_mutation_plane_runs_with_jax_blocked():
    """The mutation package, the /v1/mutate batcher, the corpus plane and
    the shadow oracle's process import, and a Runner over the FakeCluster
    ingests a mutator CR through its watch, answers /v1/mutate with a
    patch and reports its corpus on the CPU, while its shadow oracle
    process evaluates a sampled admission, in an interpreter where
    importing jax or the JAX package fails."""
    assert set(MUTATION_PLANE) <= set(_modules())
    code = (
        "import base64, importlib, json, sys, time, urllib.request\n"
        "for m in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {MUTATION_PLANE!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget\n"
        "from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver\n"
        "from gatekeeper_tpu_torch.control import FakeCluster, Runner\n"
        "c = FakeCluster()\n"
        "for t in chip_smoke.template_docs():\n"
        "    c.apply(t)\n"
        "for k in chip_smoke.constraint_docs(8):\n"
        "    c.apply(k)\n"
        "c.apply(chip_smoke.mutation_docs()[0])\n"
        "client = Backend(TorchDriver(device='cpu')).new_client(K8sValidationTarget())\n"
        "r = Runner(c, client, chip_smoke.TARGET, webhook_tls=False, audit_interval=3600.0)\n"
        "try:\n"
        "    r.start()\n"
        "    assert r.wait_ready(60)\n"
        "    while r.mutation_system.count() < 1:\n"
        "        time.sleep(0.05)\n"
        "    req = chip_smoke.admission_request(chip_smoke.make_pod(17), 'u')\n"
        "    url = f'http://127.0.0.1:{r.webhook.port}/v1/mutate'\n"
        "    out = json.loads(urllib.request.urlopen(\n"
        "        url, chip_smoke._envelope(req), timeout=60).read())\n"
        "    ops = json.loads(base64.b64decode(out['response']['patch']))\n"
        "    plane = r.integrity\n"
        "    plane.shadow_sample_n = 1\n"
        "    obj = client.targets[chip_smoke.TARGET].augment_request(req)\n"
        "    plane.note_live('t', obj, [])\n"
        "    deadline = time.monotonic() + 60\n"
        "    while not plane.shadow_evaluated and time.monotonic() < deadline:\n"
        "        time.sleep(0.05)\n"
        "    in_process = plane._oracle_proc is not None\n"
        "    corpus = r.corpus.refresh().subjects\n"
        "finally:\n"
        "    r.stop()\n"
        "print(len(ops) > 0, plane.shadow_evaluated, in_process, corpus)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "1", "True", "17"]


FLEET_PLANE = (
    "gatekeeper_tpu_torch.fleet",
    "gatekeeper_tpu_torch.fleet.certs",
    "gatekeeper_tpu_torch.fleet.plane",
    "gatekeeper_tpu_torch.fleet.store",
    "gatekeeper_tpu_torch.control.events",
    "gatekeeper_tpu_torch.externaldata.cache",
    "gatekeeper_tpu_torch.faults.injection",
)


def test_fleet_plane_runs_with_jax_blocked(tmp_path):
    """Importing gatekeeper_tpu_torch.fleet in a fresh interpreter loads
    no jax* and no gatekeeper_tpu.* module; with both blocked, two
    rotators over one FakeCluster serve one CA and two FleetPlanes gossip
    a cache entry and a breaker trip."""
    assert set(FLEET_PLANE) <= set(_modules())
    env = dict(os.environ, PYTHONPATH=ROOT)
    code = (
        "import sys\n"
        "import gatekeeper_tpu_torch.fleet\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'gatekeeper_tpu')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    code = (
        "import importlib, sys, time\n"
        "for m in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {FLEET_PLANE!r}:\n"
        "    importlib.import_module(m)\n"
        "from gatekeeper_tpu_torch.control import FakeCluster\n"
        "from gatekeeper_tpu_torch.externaldata import ExternalDataSystem\n"
        "from gatekeeper_tpu_torch.faults import CircuitBreaker\n"
        "from gatekeeper_tpu_torch.fleet import (\n"
        "    FleetCertRotator, FleetPlane, SecretCertStore)\n"
        "c = FakeCluster()\n"
        "rots = [FleetCertRotator(\n"
        f"    {str(tmp_path)!r} + '/' + r, SecretCertStore(c, replica_id=r))\n"
        "    for r in 'ab']\n"
        "for r in rots:\n"
        "    r.start(); r.ensure()\n"
        "planes, breakers = [], []\n"
        "for r in 'ab':\n"
        "    p = FleetPlane(c, r, publish_interval_s=0.01)\n"
        "    s = ExternalDataSystem()\n"
        "    p.attach_cache(s)\n"
        "    b = CircuitBreaker(failure_threshold=1)\n"
        "    p.register_breaker('device:validation', b)\n"
        "    p.start()\n"
        "    planes.append((p, s)); breakers.append(b)\n"
        "planes[0][1].cache.put('prov', 'k', value='v', ttl=60.0)\n"
        "planes[0][0].notify_cache_update()\n"
        "breakers[0].record_failure()\n"
        "deadline = time.monotonic() + 30\n"
        "while time.monotonic() < deadline and not (\n"
        "        planes[1][0].cache_merged and breakers[1].state != 'closed'):\n"
        "    time.sleep(0.01)\n"
        "for p, _ in planes:\n"
        "    p.stop()\n"
        "print(rots[0].ca_bundle() == rots[1].ca_bundle(),\n"
        "      planes[1][0].cache_merged, breakers[1].state)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "1", "half_open"]


AGENT_PLANE = (
    "gatekeeper_tpu_torch.agentaction",
    "gatekeeper_tpu_torch.agentaction.review",
    "gatekeeper_tpu_torch.agentaction.target",
    "gatekeeper_tpu_torch.integrity.canary",
    "gatekeeper_tpu_torch.ingest.server",
    "gatekeeper_tpu_torch.run",
)


def test_agent_plane_runs_with_jax_blocked():
    """The agent-action package imports with jax and the JAX package
    blocked, and a Runner over the FakeCluster with the agent target
    registered answers /v1/agent/review with a denial, derives agent
    canaries, and its shadow oracle process, whose policy now holds an
    agent template beside the K8s ones, evaluates a sampled admission."""
    assert set(AGENT_PLANE) <= set(_modules())
    code = (
        "import importlib, json, sys, time, urllib.request\n"
        "for m in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {AGENT_PLANE!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from gatekeeper_tpu_torch.agentaction import AgentActionTarget, TARGET_NAME\n"
        "from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget\n"
        "from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver\n"
        "from gatekeeper_tpu_torch.control import FakeCluster, Runner\n"
        "from gatekeeper_tpu_torch.integrity.canary import synth_agent_reviews\n"
        "rego = ('package agentshell\\n'\n"
        "        'violation[{\"msg\": \"no rm\"}] {\\n'\n"
        "        '  input.review.object.spec.arguments.command == \"rm\"\\n'\n"
        "        '}\\n')\n"
        "tmpl = {'apiVersion': 'templates.gatekeeper.sh/v1beta1',\n"
        "        'kind': 'ConstraintTemplate', 'metadata': {'name': 'agentshell'},\n"
        "        'spec': {'crd': {'spec': {'names': {'kind': 'AgentShell'}}},\n"
        "                 'targets': [{'target': TARGET_NAME, 'rego': rego}]}}\n"
        "con = {'apiVersion': 'constraints.gatekeeper.sh/v1beta1',\n"
        "       'kind': 'AgentShell', 'metadata': {'name': 'no-rm'},\n"
        "       'spec': {'match': {'tools': ['shell.*']}}}\n"
        "c = FakeCluster()\n"
        "for t in chip_smoke.template_docs() + [tmpl]:\n"
        "    c.apply(t)\n"
        "for k in chip_smoke.constraint_docs(8) + [con]:\n"
        "    c.apply(k)\n"
        "client = Backend(TorchDriver(device='cpu')).new_client(\n"
        "    K8sValidationTarget(), AgentActionTarget())\n"
        "r = Runner(c, client, chip_smoke.TARGET, webhook_tls=False, audit_interval=3600.0)\n"
        "try:\n"
        "    r.start()\n"
        "    assert r.wait_ready(60)\n"
        "    url = f'http://127.0.0.1:{r.webhook.port}/v1/agent/review'\n"
        "    body = json.dumps({'request': {'agent': 'a', 'tool': 'shell.exec',\n"
        "                                   'arguments': {'command': 'rm'}}})\n"
        "    out = json.loads(urllib.request.urlopen(\n"
        "        url, body.encode(), timeout=60).read())['response']\n"
        "    canaries = synth_agent_reviews([con], k=3)\n"
        "    plane = r.integrity\n"
        "    plane.shadow_sample_n = 1\n"
        "    req = chip_smoke.admission_request(chip_smoke.make_pod(17), 'u')\n"
        "    obj = client.targets[chip_smoke.TARGET].augment_request(req)\n"
        "    plane.note_live('t', obj, [])\n"
        "    deadline = time.monotonic() + 60\n"
        "    while not plane.shadow_evaluated and time.monotonic() < deadline:\n"
        "        time.sleep(0.05)\n"
        "finally:\n"
        "    r.stop()\n"
        "print(out['allowed'], len(canaries), plane.shadow_evaluated,\n"
        "      plane.snapshot()['shadow']['divergences'])\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "3", "1", "0"]


STORE_PLANES = (
    "gatekeeper_tpu_torch.compile",
    "gatekeeper_tpu_torch.compile.store",
    "gatekeeper_tpu_torch.obs.flightrecorder",
    "gatekeeper_tpu_torch.analysis.cli",
    "gatekeeper_tpu_torch.analysis.canarygate",
)


def test_store_recorder_and_analysis_cli_run_with_jax_blocked(tmp_path):
    """The compile-artifact store, the flight recorder and the offline
    analysis CLI import and run with jax and the JAX package blocked: a
    store attests a host library and a second store adopts it, the
    recorder captures a trigger to disk, and `all` gates deploy/policies
    (the canary gate on TorchDriver on the CPU)."""
    assert set(STORE_PLANES) <= set(_modules())
    code = (
        "import importlib, io, os, sys, time, contextlib\n"
        "for m in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {STORE_PLANES!r}:\n"
        "    importlib.import_module(m)\n"
        "from gatekeeper_tpu_torch.compile import ProgramStore\n"
        "from gatekeeper_tpu_torch.kernels import build\n"
        "from gatekeeper_tpu_torch import native\n"
        "from gatekeeper_tpu_torch.obs import FlightRecorder\n"
        "from gatekeeper_tpu_torch.analysis.cli import run\n"
        f"root = {str(tmp_path / 'store')!r}\n"
        "build._store.append(ProgramStore(root))\n"
        "exe = native.build_frontend()\n"
        "again = ProgramStore(root)\n"
        f"rec = FlightRecorder(dir={str(tmp_path / 'fr')!r}, debounce_s=0.0)\n"
        "rec.trigger('breaker_open', breaker='device:validation')\n"
        "deadline = time.monotonic() + 10\n"
        "while not rec.captured and time.monotonic() < deadline:\n"
        "    time.sleep(0.01)\n"
        "rec.stop()\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    rc = run(['all', 'deploy/policies'])\n"
        f"print(again.hits, rec.captured, len(os.listdir({str(tmp_path / 'fr')!r})), rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("GATEKEEPER_TPU_NO_COMPILE_CACHE", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-4:] == ["1", "1", "1", "0"]


def test_entry_and_inventory_joins_run_with_jax_blocked():
    """The harness step (gatekeeper_tpu_torch.entry) and an audit over the
    uniqueness joins run on the CPU in an interpreter where importing jax
    or the JAX package fails."""
    assert "gatekeeper_tpu_torch.entry" in _modules()
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import chip_smoke\n"
        "from gatekeeper_tpu_torch.entry import entry\n"
        "from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver\n"
        "fn, args = entry(device='cpu')\n"
        "match, counts, totals = fn(*args)\n"
        "drv = TorchDriver(device='cpu')\n"
        "c = chip_smoke.build_mixed_client(drv, 300, 6)\n"
        "r = c.audit().by_target[chip_smoke.TARGET].results\n"
        "print(int(totals.sum()), drv.stats['pruned_renders'], len(r))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    totals, pruned, results = map(int, out.stdout.split())
    assert totals > 0 and pruned > 0 and results > 0


SOAK_PLANE = (
    "gatekeeper_tpu_torch.summary",
    "gatekeeper_tpu_torch.soak",
    "gatekeeper_tpu_torch.soak.loadgen",
    "gatekeeper_tpu_torch.soak.scenario",
    "gatekeeper_tpu_torch.soak.report",
)


def test_summary_and_soak_run_with_jax_blocked():
    """The SUMMARY contract and the soak modules import, and a short open
    loop, its report and its SUMMARY line round-trip, in an interpreter
    where importing jax or the JAX package fails."""
    assert set(SOAK_PLANE) <= set(_modules())
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {SOAK_PLANE!r}:\n"
        "    importlib.import_module(m)\n"
        "from gatekeeper_tpu_torch import soak\n"
        "scn = soak.Scenario.from_dict({'duration_s': 0.5, 'rps': 40,\n"
        "    'window_s': 0.25, 'planes': {'validation': 1.0},\n"
        "    'events': [{'at': 0, 'action': 'phase', 'name': 'steady'}]})\n"
        "load = soak.run_open_loop(lambda p: (200, 'ok'), scn.rps,\n"
        "    scn.duration_s, scn.deadline_s, planes=scn.planes, seed=1)\n"
        "rep = soak.build_report(scn.to_dict(), load, [], [], {})\n"
        "assert soak.check_soak_schema(rep) == []\n"
        "doc = soak.parse_summary_line(soak.summarize_soak(rep))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'gatekeeper_tpu') and sys.modules[k])\n"
        "print(doc['mode'], load.generated > 5, bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["soak", "True", "[]"]


def test_no_jax_import_statements():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert bad == []


def test_driver_without_cuda_raises(monkeypatch):
    from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDriver()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDriver("cuda")
    assert TorchDriver(device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device (and, separately, without the package beside
    it) chip_smoke.py exits nonzero and prints no result line."""
    runs = []
    if not torch.cuda.is_available():
        runs.append(ROOT)
    lone = tmp_path / "alone"
    lone.mkdir()
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (lone / "chip_smoke.py").write_text(f.read())
    runs.append(str(lone))
    for cwd in runs:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
