"""The port's fleet plane (gatekeeper_tpu_torch/fleet) on the CPU, held
against the JAX package's: each scenario of tests/test_fleet.py runs on
both packages from the same inputs and the outcomes must be equal —
fetched keys, merge and adoption counts, breaker state sequences, cert
generations, conflict counts and the /readyz stats.fleet keys. All of it
is host code, so the bar is exact equality. Then the mixed fleet: a
FleetState object and a cert Secret written by one package are read by
the other with equal results, as when a fleet is migrated replica by
replica; `KubeCluster.create` raises `Conflict` on the apiserver's 409;
and two port replicas boot through `run.build_runner` over one mock
apiserver and serve one CA."""

import datetime
import json
import ssl
import threading
import time
import urllib.request
from types import SimpleNamespace

import pytest

import gatekeeper_tpu.constraint as j_constraint
import gatekeeper_tpu.control as j_control
import gatekeeper_tpu.control.events as j_events
import gatekeeper_tpu.externaldata as j_externaldata
import gatekeeper_tpu.externaldata.cache as j_cache
import gatekeeper_tpu.faults as j_faults
import gatekeeper_tpu.fleet as j_fleet
import gatekeeper_tpu.metrics as j_metrics
import gatekeeper_tpu.webhook.server as j_server
import gatekeeper_tpu_torch.constraint as t_constraint
import gatekeeper_tpu_torch.control as t_control
import gatekeeper_tpu_torch.control.events as t_events
import gatekeeper_tpu_torch.externaldata as t_externaldata
import gatekeeper_tpu_torch.externaldata.cache as t_cache
import gatekeeper_tpu_torch.faults as t_faults
import gatekeeper_tpu_torch.fleet as t_fleet
import gatekeeper_tpu_torch.metrics as t_metrics
import gatekeeper_tpu_torch.webhook.server as t_server
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from test_kubecluster import REQ_LABELS as K8S_REQ_LABELS
from test_kubecluster import MockApiServer, config, constraint, pod, template

pytestmark = pytest.mark.fleet

TARGET = "admission.k8s.gatekeeper.sh"
SECRET_NAME = "gatekeeper-webhook-server-cert"

REQ_LABELS = """package reqlabels

violation[{"msg": msg}] {
    required := {key | key := input.parameters.labels[_]}
    provided := {key | input.review.object.metadata.labels[key]}
    missing := required - provided
    count(missing) > 0
    msg := sprintf("missing: %v", [missing])
}
"""


def _pkg(constraint_mod, control, events, externaldata, cache, faults,
         fleet, metrics, server, runner_driver):
    return SimpleNamespace(
        constraint=constraint_mod, control=control, events=events,
        externaldata=externaldata, cache=cache, faults=faults, fleet=fleet,
        MetricsRegistry=metrics.MetricsRegistry, server=server,
        runner_driver=runner_driver,
    )


# the Runner scenario builds the port's client on TorchDriver (on the
# CPU), as the port's Runner tests do; every other client runs on the
# interpreter, as in tests/test_fleet.py
PKGS = {
    "jax": _pkg(j_constraint, j_control, j_events, j_externaldata, j_cache,
                j_faults, j_fleet, j_metrics, j_server,
                lambda: j_constraint.RegoDriver()),
    "torch": _pkg(t_constraint, t_control, t_events, t_externaldata,
                  t_cache, t_faults, t_fleet, t_metrics, t_server,
                  lambda: TorchDriver(device="cpu")),
}


@pytest.fixture(autouse=True)
def _reset_faults():
    for p in PKGS.values():
        p.faults.FAULTS.reset()
    yield
    for p in PKGS.values():
        p.faults.FAULTS.reset()


def both(scenario, *args, **kw):
    """Run `scenario(pkg, *args)` on the JAX package, then on the port;
    their outcomes must be equal. Returns the port's."""
    out = {name: scenario(pkg, name, *args, **kw)
           for name, pkg in PKGS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def new_client(p, driver=None):
    cl = p.constraint.Backend(
        driver if driver is not None else p.constraint.RegoDriver()
    ).new_client(p.constraint.K8sValidationTarget())
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


def admission_request(name="p", labels=None, uid="u1"):
    obj = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": name,
            "namespace": "default",
            **({"labels": labels} if labels else {}),
        },
        "spec": {"containers": [{"name": "c", "image": "nginx"}]},
    }
    return {
        "uid": uid,
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "operation": "CREATE",
        "userInfo": {"username": "alice"},
        "object": obj,
    }


def fleet_rotator(p, cluster, replica, root, metrics=None):
    store = p.fleet.SecretCertStore(cluster, replica_id=replica,
                                    metrics=metrics)
    rot = p.fleet.FleetCertRotator(str(root / replica), store,
                                   metrics=metrics)
    rot.start()
    return rot


def due_for_rotation(rot):
    """Make `rot`'s next ensure() find its pair inside the 90-day
    lookahead: its expiry check reads a clock 335 days on, while the pair
    it generates is stamped on the real clock (the `cryptography`
    generator stamps the rotator's clock, the `openssl` one real time, so
    either way the new pair is valid now). Returns the undo."""
    real = rot._now
    future = real() + datetime.timedelta(days=365 - 30)
    generate = rot.generate_pair

    def generate_now():
        rot._now = real
        return generate()

    rot._now = lambda: future
    rot.generate_pair = generate_now

    def undo():
        rot._now = real
        del rot.generate_pair

    return undo


def wait_for(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def counter_names(metrics):
    return sorted({k.split("{")[0] for k in metrics.snapshot()["counters"]})


# -- the shared cert store ---------------------------------------------------


def test_load_or_create_one_ca(tmp_path):
    def run(p, name):
        cluster = p.events.FakeCluster()
        ra = fleet_rotator(p, cluster, "a", tmp_path / name)
        rb = fleet_rotator(p, cluster, "b", tmp_path / name)
        ra.ensure()
        rb.ensure()
        sec = cluster.get(p.fleet.SECRET_GVK, "gatekeeper-system", SECRET_NAME)
        return {
            "one_ca": ra.ca_bundle() == rb.ca_bundle(),
            "rotations": (ra.rotations, rb.rotations),
            "generations": (ra.cert_generation, rb.cert_generation),
            "secret_keys": sorted(sec["data"]),
            "annotations": sorted(sec["metadata"]["annotations"].items()),
            "conflicts": (ra.store.conflicts, rb.store.conflicts),
        }

    out = both(run)
    assert out["one_ca"] and out["rotations"] == (1, 0)
    assert out["generations"] == (1, 1)
    assert out["secret_keys"] == ["ca.crt", "tls.crt", "tls.key"]


def test_empty_placeholder_secret_is_populated(tmp_path):
    def run(p, name):
        cluster = p.events.FakeCluster()
        cluster.apply({
            "apiVersion": "v1", "kind": "Secret", "type": "Opaque",
            "metadata": {"name": SECRET_NAME,
                         "namespace": "gatekeeper-system"},
        })
        store = p.fleet.SecretCertStore(cluster, replica_id="a")
        before = store.load()
        rot = p.fleet.FleetCertRotator(str(tmp_path / name), store)
        rot.ensure()
        return {"before": before, "after": store.load() is not None,
                "generation": rot.cert_generation,
                "conflicts": store.conflicts}

    out = both(run)
    assert out == {"before": None, "after": True, "generation": 1,
                   "conflicts": 0}


def test_create_conflict_race_converges(tmp_path):
    """Four replicas boot at once over one cluster: one creation wins and
    every loser serves the winner's CA; a create of an existing object
    raises the package's Conflict; an offer made on a stale load adopts
    the winner and counts one conflict."""
    def run(p, name):
        cluster = p.events.FakeCluster()
        rots = [fleet_rotator(p, cluster, f"r{i}", tmp_path / name)
                for i in range(4)]
        barrier = threading.Barrier(len(rots))
        errs = []

        def boot(rot):
            try:
                barrier.wait(timeout=10)
                rot.ensure()
            except Exception as e:  # pragma: no cover - diagnostic
                errs.append(e)

        threads = [threading.Thread(target=boot, args=(r,)) for r in rots]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        raised = False
        try:
            cluster.create(cluster.list(p.fleet.SECRET_GVK)[0])
        except p.events.Conflict:
            raised = True
        # a late offer on a stale load (generation 0) loses to the store
        late = p.fleet.SecretCertStore(cluster, replica_id="late")
        winner, won = late.offer(rots[0].generate_pair(), 0)
        return {
            "errors": errs,
            "alive": [t.is_alive() for t in threads],
            "bundles": len({r.ca_bundle() for r in rots}),
            "rotations": sum(r.rotations for r in rots),
            "generations": sorted({r.cert_generation for r in rots}),
            "create_conflict": raised,
            "late": (won, winner.generation, late.conflicts,
                     winner.artifacts["ca.crt"] == rots[0].ca_bundle()),
        }

    out = both(run)
    assert out["bundles"] == 1 and out["rotations"] == 1
    assert out["create_conflict"] and out["late"] == (False, 1, 1, True)


def test_rotation_propagates_without_restart(tmp_path):
    def run(p, name):
        cluster = p.events.FakeCluster()
        metrics = p.MetricsRegistry()
        ra = fleet_rotator(p, cluster, "a", tmp_path / name, metrics)
        rb = fleet_rotator(p, cluster, "b", tmp_path / name, metrics)
        ra.ensure()
        rb.ensure()
        fired = []
        rb.on_rotate(lambda: fired.append(rb.cert_generation))
        undo = due_for_rotation(ra)
        ra.ensure()
        undo()
        return {
            "a": (ra.rotations, ra.cert_generation, ra.rotations_adopted),
            "b": (rb.rotations, rb.cert_generation, rb.rotations_adopted),
            "fired": fired,
            "one_ca": ra.ca_bundle() == rb.ca_bundle(),
            "counters": counter_names(metrics),
        }

    out = both(run)
    # B adopts A's first pair through the watch too (it started watching
    # before A created the Secret), then A's rotation
    assert out["a"] == (2, 2, 0) and out["b"] == (0, 2, 2)
    assert out["fired"] == [2] and out["one_ca"]
    assert "fleet_cert_rotations_adopted_total" in out["counters"]


def test_rotate_race_single_winner(tmp_path):
    def run(p, name):
        cluster = p.events.FakeCluster()
        ra = fleet_rotator(p, cluster, "a", tmp_path / name)
        rb = fleet_rotator(p, cluster, "b", tmp_path / name)
        ra.ensure()
        rb.ensure()
        undos = [due_for_rotation(r) for r in (ra, rb)]
        barrier = threading.Barrier(2)

        def rotate(rot):
            barrier.wait(timeout=10)
            rot.ensure()

        threads = [threading.Thread(target=rotate, args=(r,))
                   for r in (ra, rb)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for undo in undos:
            undo()
        final = ra.store.load()
        return {
            "one_ca": ra.ca_bundle() == rb.ca_bundle(),
            "generations": (ra.cert_generation, rb.cert_generation,
                            final.generation),
            "served_is_stored": ra.ca_bundle() == final.artifacts["ca.crt"],
        }

    assert both(run) == {"one_ca": True, "generations": (2, 2, 2),
                         "served_is_stored": True}


def test_install_never_tears_the_pair(tmp_path):
    """Concurrent readers of ca.crt and tls.crt while the store rotates
    three times. Every file a reader sees is a whole artifact of an
    installed generation (the installs write, then rename), and once each
    install returns, tls.crt's chained second block equals ca.crt. A
    reader between two renames may see ca.crt new and tls.crt old, and a
    fast rotation can pass a reader that re-reads after a millisecond (as
    tests/test_fleet.py's does, which then fails about 2 runs in 5 where
    the fast `cryptography` generator is installed), so the pair is
    compared at rest."""
    marker = b"-----BEGIN CERTIFICATE-----"

    def chain_ca(chain: bytes) -> bytes:
        return marker + chain.split(marker)[2]

    def run(p, name):
        rot = p.fleet.FleetCertRotator(
            str(tmp_path / name),
            p.fleet.SecretCertStore(p.events.FakeCluster(), replica_id="t"),
        )
        rot.ensure()
        # a generation's CA joins the set before its install starts
        installed = {rot.ca_bundle()}
        stop = threading.Event()
        reads, partial = [0], [0]

        def reader():
            while not stop.is_set():
                with open(rot.ca_path, "rb") as f:
                    ca = f.read()
                with open(rot.cert_path, "rb") as f:
                    chain = f.read()
                reads[0] += 1
                if ca not in installed or chain_ca(chain) not in installed:
                    partial[0] += 1

        threads = [threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        wins, at_rest = [], []
        try:
            for _ in range(3):
                winner, won = rot.store.offer(
                    rot.generate_pair(),
                    expected_generation=rot.cert_generation,
                )
                wins.append(won)
                installed.add(winner.artifacts["ca.crt"])
                rot._install_record(winner)
                with open(rot.cert_path, "rb") as f:
                    at_rest.append(chain_ca(f.read()) == rot.ca_bundle()
                                   == winner.artifacts["ca.crt"])
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        return {"partial": partial[0], "read": reads[0] > 0,
                "at_rest": at_rest, "wins": wins,
                "generation": rot.cert_generation,
                "alive": [t.is_alive() for t in threads]}

    assert both(run) == {"partial": 0, "read": True, "at_rest": [True] * 3,
                         "wins": [True] * 3, "generation": 4,
                         "alive": [False, False]}


def test_two_webhook_servers_one_ca_e2e(tmp_path):
    """Two WebhookServers over one cluster serve one CA; a client holding
    that one bundle verifies both, and after a rotation on A both serve
    the new pair to new handshakes without a restart."""
    body = json.dumps({
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": admission_request(labels={"app": "x"}),
    }).encode()

    def post(server, ctx):
        r = urllib.request.urlopen(
            urllib.request.Request(
                f"https://localhost:{server.port}/v1/admit", data=body,
                headers={"Content-Type": "application/json"}),
            timeout=30, context=ctx)
        return json.loads(r.read())["response"]["allowed"]

    def run(p, name):
        cluster = p.events.FakeCluster()
        client = new_client(p)
        rots, servers = [], []
        try:
            for rid in ("a", "b"):
                rot = fleet_rotator(p, cluster, rid, tmp_path / name)
                server = p.server.WebhookServer(
                    client, TARGET, window_ms=1.0, tls=True, rotator=rot)
                server.start()
                rots.append(rot)
                servers.append(server)
            ctx = ssl.create_default_context(
                cadata=rots[0].ca_bundle().decode())
            before = [post(s, ctx) for s in servers]
            undo = due_for_rotation(rots[0])
            rots[0].ensure()
            undo()
            ctx_new = ssl.create_default_context(
                cadata=rots[1].ca_bundle().decode())
            after = [post(s, ctx_new) for s in servers]
            return {"before": before, "after": after,
                    "generations": [r.cert_generation for r in rots],
                    "adopted": [r.rotations_adopted for r in rots]}
        finally:
            for server in servers:
                server.stop()

    assert both(run) == {"before": [False, False], "after": [False, False],
                         "generations": [2, 2], "adopted": [0, 1]}


# -- the shared external-data cache ------------------------------------------


def two_cache_replicas(p, cluster, provider_obj):
    planes, systems = [], []
    for rid in ("a", "b"):
        plane = p.fleet.FleetPlane(cluster, rid, publish_interval_s=0.01)
        system = p.externaldata.ExternalDataSystem()
        plane.attach_cache(system)
        system.upsert(provider_obj)
        plane.start()
        planes.append(plane)
        systems.append(system)
    return planes, systems


def test_cache_one_fetch_per_key_fleetwide(stub_provider):
    """Eight keys spread over two replicas cost one outbound fetch per key
    fleet-wide; afterwards either replica resolves all eight from its
    cache."""
    def run(p, name):
        stub_provider.requests.clear()
        cluster = p.events.FakeCluster()
        (pa, pb), (sa, sb) = two_cache_replicas(
            p, cluster, stub_provider.provider_obj())
        try:
            keys = [f"k{i}" for i in range(8)]
            sa.begin_batch()
            sa.resolve("stub-provider", keys[0::2])
            wait_for(lambda: pb.cache_merged >= 4, msg="B merging A")
            sb.begin_batch()
            sb.resolve("stub-provider", keys[1::2])
            wait_for(lambda: pa.cache_merged >= 4, msg="A merging B")
            sa.begin_batch()
            full_a = sa.resolve("stub-provider", keys)
            sb.begin_batch()
            full_b = sb.resolve("stub-provider", keys)
            return {
                "fetched": sorted(k for req in stub_provider.requests
                                  for k in req),
                "fetches": (sa.fetch_count, sb.fetch_count),
                "responses": (full_a["responses"], full_b["responses"]),
            }
        finally:
            pa.stop()
            pb.stop()

    out = both(run)
    assert out["fetched"] == [f"k{i}" for i in range(8)]
    assert out["fetches"] == (1, 1)
    assert out["responses"][0] == out["responses"][1]


def test_cache_merge_preserves_negative_and_ttl(stub_provider):
    def run(p, name):
        stub_provider.requests.clear()
        cluster = p.events.FakeCluster()
        (pa, pb), (sa, sb) = two_cache_replicas(
            p, cluster, stub_provider.provider_obj())
        try:
            sa.begin_batch()
            out_a = sa.resolve("stub-provider", ["bad.key", "good"])
            wait_for(lambda: pb.cache_merged >= 2, msg="negative merge")
            n0 = stub_provider.fetch_count
            sb.begin_batch()
            out_b = sb.resolve("stub-provider", ["bad.key", "good"])
            wire = {"b_fetches": stub_provider.fetch_count - n0,
                    "a": (out_a["responses"], out_a["errors"]),
                    "b": (out_b["responses"], out_b["errors"])}
        finally:
            pa.stop()
            pb.stop()
        # age re-anchoring under an injected clock
        t = [1000.0]
        cache = p.cache.ResponseCache(clock=lambda: t[0])
        seq = [cache.merge({"provider": "p", "key": "k", "value": "v",
                            "age_s": 290.0, "ttl": 300.0, "stale_ttl": 0.0},
                           origin="peer")]
        seq.append(cache.classify("p", ["k"])["k"][0])
        t[0] += 15.0
        seq.append(cache.classify("p", ["k"])["k"][0])
        seq.append(cache.merge({"provider": "p", "key": "k2", "value": "v",
                                "age_s": 400.0, "ttl": 300.0,
                                "stale_ttl": 0.0}, origin="peer"))
        seq.append(cache.merge({"provider": "p", "key": "neg",
                                "error": "unsigned", "age_s": 0.0,
                                "ttl": 300.0, "stale_ttl": 0.0},
                               origin="peer"))
        state, entry = cache.classify("p", ["neg"])["neg"]
        seq.append((state, entry.error, entry.origin))
        return dict(wire, seq=seq)

    out = both(run)
    assert out["b_fetches"] == 0 and out["a"] == out["b"]
    assert out["seq"] == [True, "hit", "miss", False, True,
                          ("negative_hit", "unsigned", "peer")]


def test_merged_entries_never_echo(stub_provider):
    def run(p, name):
        cluster = p.events.FakeCluster()
        (pa, pb), (sa, sb) = two_cache_replicas(
            p, cluster, stub_provider.provider_obj())
        try:
            sa.begin_batch()
            sa.resolve("stub-provider", ["k1", "k2"])
            wait_for(lambda: pb.cache_merged >= 2, msg="merge")
            empty = sb.cache.export_fresh()
            sb.begin_batch()
            sb.resolve("stub-provider", ["k3"])
            return {"before": empty,
                    "after": sorted(r["key"]
                                    for r in sb.cache.export_fresh())}
        finally:
            pa.stop()
            pb.stop()

    assert both(run) == {"before": [], "after": ["k3"]}


# -- breaker adoption ---------------------------------------------------------


def test_breaker_adopt_semantics():
    """A peer's OPEN pre-opens a CLOSED breaker to HALF_OPEN, a peer's
    CLOSED lets an OPEN one probe early, a peer's HALF_OPEN is never
    adopted and nothing adopts straight to OPEN."""
    def run(p, name):
        f = p.faults
        b = f.CircuitBreaker(failure_threshold=3, recovery_seconds=30)
        seq = [(b.adopt(f.OPEN), b.state), b.allow(), b.allow()]
        b.record_success()
        seq += [b.state, b.adopt(f.CLOSED), b.adopt(f.HALF_OPEN)]
        for _ in range(3):
            b.record_failure()
        seq += [b.state, b.adopt(f.OPEN), b.adopt(f.HALF_OPEN), b.state,
                (b.adopt(f.CLOSED), b.state), b.adoptions]
        return seq

    assert both(run) == [(True, "half_open"), True, False, "closed", False,
                         False, "open", False, False, "open",
                         (True, "half_open"), 2]


def test_breaker_adoption_e2e_under_faults():
    """A's fused dispatch fails three times and its breaker opens; B's
    breaker goes HALF_OPEN from the gossip without a failure of its own;
    B's probe succeeds and the recovery lets A probe early. The JAX
    batcher answers A's failed batches on the host interpreter; the
    port's answers them with EvaluationUnavailable (the fail policy,
    ROADMAP §C): the breaker and gossip outcomes are equal."""
    def run(p, name):
        f = p.faults
        cluster = p.events.FakeCluster()
        metrics = p.MetricsRegistry()
        pa = p.fleet.FleetPlane(cluster, "a", publish_interval_s=0.01,
                                metrics=metrics)
        pb = p.fleet.FleetPlane(cluster, "b", publish_interval_s=0.01,
                                metrics=metrics)
        ba = p.server.MicroBatcher(new_client(p), TARGET, window_ms=1.0)
        bb = p.server.MicroBatcher(new_client(p), TARGET, window_ms=1.0)
        pa.register_breaker("device:validation", ba.breaker)
        pb.register_breaker("device:validation", bb.breaker)
        for x in (pa, pb, ba, bb):
            x.start()
        answers = []
        try:
            f.FAULTS.arm("webhook.batch_dispatch", mode="error", count=3)
            for i in range(3):
                fut = ba.submit(admission_request(f"a{i}", uid=f"a{i}"))
                try:
                    res = fut.result(timeout=10)
                    answers.append(sorted(r.enforcement_action for r in res))
                except f.EvaluationUnavailable:
                    answers.append("unavailable")
            a_state = ba.breaker.state
            wait_for(lambda: bb.breaker.state == f.HALF_OPEN,
                     msg="B adopting A's trip")
            b_failures = bb.breaker.snapshot()["consecutive_failures"]
            f.FAULTS.reset()
            bb.submit(admission_request("b0", uid="b0")).result(timeout=10)
            wait_for(lambda: bb.breaker.state == f.CLOSED,
                     msg="B's probe closing")
            wait_for(lambda: ba.breaker.state in (f.HALF_OPEN, f.CLOSED),
                     msg="A adopting B's recovery")
            return {
                "a_after_faults": a_state,
                "b_failures": (b_failures, bb.batch_failures),
                "a_failures": ba.batch_failures,
                "adopted": (pa.breaker_adoptions >= 1,
                            pb.breaker_adoptions >= 1),
                "counters": counter_names(metrics),
                "answers": answers,
            }
        finally:
            f.FAULTS.reset()
            for x in (ba, bb, pa, pb):
                x.stop()

    out = {name: run(pkg, name) for name, pkg in PKGS.items()}
    assert out["jax"].pop("answers") == [["deny"]] * 3
    assert out["torch"].pop("answers") == ["unavailable"] * 3
    assert out["torch"] == out["jax"]
    assert out["torch"]["a_after_faults"] == "open"
    assert out["torch"]["b_failures"] == (0, 0)
    assert out["torch"]["adopted"] == (True, True)
    assert "fleet_breaker_adoptions_total" in out["torch"]["counters"]


def test_provider_breaker_gossips(stub_provider):
    def run(p, name):
        cluster = p.events.FakeCluster()
        (pa, pb), (sa, sb) = two_cache_replicas(
            p, cluster, stub_provider.provider_obj())
        stub_provider.fail = True
        try:
            for _ in range(3):
                sa.begin_batch()
                sa.resolve("stub-provider", ["x"])
            a_state = sa.breaker("stub-provider").state
            wait_for(lambda: sb.breaker("stub-provider").state == "half_open",
                     msg="provider breaker adoption")
            return {"a": a_state, "b": sb.breaker("stub-provider").state,
                    "registered": (pa.snapshot()["breakers"],
                                   pb.snapshot()["breakers"])}
        finally:
            stub_provider.fail = False
            pa.stop()
            pb.stop()

    assert both(run) == {"a": "open", "b": "half_open", "registered": (
        ["provider:stub-provider"], ["provider:stub-provider"])}


# -- the Runner's wiring ------------------------------------------------------


def test_runner_fleet_wiring_and_readyz(tmp_path):
    """Two Runners (webhook and status) over one FakeCluster: one Secret
    and one CA, a FleetState CR per replica, and stats.fleet on /readyz
    with the cert generation, the peer and the registered breakers."""
    def run(p, name):
        cluster = p.events.FakeCluster()
        runners = []
        try:
            for rid in ("pod-a", "pod-b"):
                r = p.control.Runner(
                    cluster, new_client(p, p.runner_driver()), TARGET,
                    operations=("webhook", "status"), pod_name=rid,
                    webhook_tls=True, cert_secret=SECRET_NAME,
                    cert_dir=str(tmp_path / name / rid), readyz_port=0,
                    audit_interval=3600.0)
                r.start()
                runners.append(r)
            ready = [r.wait_ready(60) for r in runners]
            wait_for(lambda: "pod-b" in runners[0].fleet.snapshot()["peers"],
                     msg="peer discovery")
            out = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{runners[0].readyz_port}/readyz",
                timeout=10).read())
            fl = out["stats"]["fleet"]
            return {
                "ready": ready,
                "cas": len({r.webhook.rotator.ca_bundle() for r in runners}),
                "secrets": len(cluster.list(p.fleet.SECRET_GVK)),
                "states": sorted(s["metadata"]["name"] for s in
                                 cluster.list(p.fleet.FLEETSTATE_GVK)),
                "fleet_keys": sorted(fl),
                "fleet": {k: fl[k] for k in (
                    "replica", "cert_generation", "breakers",
                    "cert_rotations_adopted", "publish_failures")},
                "peers": fl["peers"],
                "component": "component/fleet" in out["stats"],
            }
        finally:
            # in reverse: each Runner restores the collector thresholds it
            # found when it set its own
            for r in reversed(runners):
                r.stop()

    out = both(run)
    assert out["ready"] == [True, True] and out["cas"] == 1
    assert out["secrets"] == 1 and out["states"] == ["pod-a", "pod-b"]
    assert out["fleet"]["cert_generation"] == 1
    assert "device:validation" in out["fleet"]["breakers"]
    assert out["peers"] == ["pod-b"] and out["component"]


def test_agent_breaker_trip_adopted_by_peer():
    """Two Runners with the agent target registered mount the agent plane
    and gossip its `device:agent` breaker: three failed agent batches on
    A open A's breaker and B's goes HALF_OPEN from the gossip without a
    failure of its own, on both packages. A's three answers differ as in
    the validation plane's case above: the JAX package's are its
    interpreter's denials, the port's the fail policy's."""
    from test_agentaction import SHELL_REGO, agent_constraint, agent_template

    mods = {"jax": "gatekeeper_tpu.agentaction",
            "torch": "gatekeeper_tpu_torch.agentaction"}

    def run(p, name):
        import importlib

        agent = importlib.import_module(mods[name])
        f = p.faults
        cluster = p.events.FakeCluster()
        runners = []
        try:
            for rid in ("pod-a", "pod-b"):
                client = p.constraint.Backend(p.runner_driver()).new_client(
                    p.constraint.K8sValidationTarget(),
                    agent.AgentActionTarget())
                client.add_template(agent_template("AgentShellAllowlist",
                                                   SHELL_REGO))
                client.add_constraint(agent_constraint(
                    "AgentShellAllowlist", "shell-allowlist",
                    match={"tools": ["shell.*"]},
                    params={"allowed": ["ls"]}))
                r = p.control.Runner(
                    cluster, client, TARGET, operations=("webhook",),
                    pod_name=rid, webhook_tls=False, readyz_port=0,
                    audit_interval=3600.0)
                r.start()
                runners.append(r)
            ready = [r.wait_ready(60) for r in runners]
            a, b = (r.webhook for r in runners)
            f.FAULTS.arm("webhook.batch_dispatch", mode="error", count=3)
            answers = [a.agent_handler.handle({
                "agent": "planner-1", "tool": "shell.exec",
                "arguments": {"command": "rm"}}) for _ in range(3)]
            a_state = a.agent_batcher.breaker.state
            wait_for(lambda: b.agent_batcher.breaker.state == f.HALF_OPEN,
                     msg="B adopting A's agent trip")
            return {
                "ready": ready,
                "registered": [sorted(r.fleet.snapshot()["breakers"])
                               for r in runners],
                "a_after_faults": a_state,
                "a_failures": a.agent_batcher.batch_failures,
                "b": (b.agent_batcher.breaker.state,
                      b.agent_batcher.batch_failures,
                      b.batcher.breaker.state),
                "answers": [(x.allowed, x.code) for x in answers],
            }
        finally:
            f.FAULTS.reset()
            for r in reversed(runners):
                r.stop()

    out = {name: run(pkg, name) for name, pkg in PKGS.items()}
    assert out["jax"].pop("answers") == [(False, 403)] * 3
    assert out["torch"].pop("answers") == [(True, 200)] * 3
    assert out["torch"] == out["jax"]
    assert out["torch"]["ready"] == [True, True]
    assert out["torch"]["registered"] == [
        ["device:agent", "device:mutation", "device:validation"]] * 2
    assert out["torch"]["a_after_faults"] == "open"
    assert out["torch"]["b"] == ("half_open", 0, "closed")


# -- a mixed fleet: JAX and port replicas share the wire state ---------------


def _seed_cache(p, clock):
    """An ExternalDataSystem whose cache holds the same seeded entries on
    either package: values, negative entries and a stale window."""
    system = p.externaldata.ExternalDataSystem(clock=clock)
    system.upsert({
        "apiVersion": "externaldata.gatekeeper.sh/v1alpha1",
        "kind": "Provider", "metadata": {"name": "prov"},
        "spec": {"url": "http://127.0.0.1:9/validate", "timeout": 1},
    })
    for i in range(12):
        if i % 4 == 3:
            system.cache.put("prov", f"bad{i}", error="unsigned", ttl=60.0)
        else:
            system.cache.put("prov", f"img{i}", value={"digest": f"d{i}"},
                             ttl=300.0, stale_ttl=30.0 * (i % 3))
        clock.t += 1.25
    return system


class _Clock:
    def __init__(self, t=5000.0):
        self.t = t

    def __call__(self):
        return self.t


def _plane(p, clock, states):
    system = _seed_cache(p, clock)
    plane = p.fleet.FleetPlane(p.events.FakeCluster(), "replica-x",
                               namespace="gatekeeper-system")
    plane.attach_cache(system)
    for name, (fails, adopt) in sorted(states.items()):
        b = p.faults.CircuitBreaker(failure_threshold=3, clock=clock)
        for _ in range(fails):
            b.record_failure()
        if adopt:
            b.adopt(adopt)
        plane.register_breaker(name, b)
    return plane, system


BREAKERS = {"device:validation": (3, None), "device:mutation": (0, "open"),
            "provider:prov": (1, None)}


def test_state_obj_is_byte_equal_under_a_fixed_clock():
    """The same cache entries and breaker states publish the same
    FleetState bytes from either package."""
    objs = {}
    for name, p in PKGS.items():
        plane, _ = _plane(p, _Clock(), BREAKERS)
        objs[name] = json.dumps(plane.state_obj()).encode()
    assert objs["torch"] == objs["jax"]
    spec = json.loads(objs["torch"])["spec"]
    assert len(spec["cache"]) == 12
    assert [b["state"] for b in spec["breakers"]] == [
        "half_open", "open", "closed"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_side_merges_the_others_fleet_state(writer):
    """A FleetState object published by one package, merged into a replica
    of each package: equal caches (classification and entries, TTL windows
    re-anchored by age) and equal breaker states and adoption counts."""
    src, _ = _plane(PKGS[writer], _Clock(), BREAKERS)
    obj = json.loads(json.dumps(src.state_obj()))
    keys = [f"img{i}" for i in range(12)] + [f"bad{i}" for i in range(12)]
    out = {}
    for name, p in PKGS.items():
        clock = _Clock(9000.0)
        system = p.externaldata.ExternalDataSystem(clock=clock)
        plane = p.fleet.FleetPlane(p.events.FakeCluster(), "replica-y",
                                   namespace="gatekeeper-system")
        plane.attach_cache(system)
        breakers = {}
        for bname in BREAKERS:
            breakers[bname] = p.faults.CircuitBreaker(
                failure_threshold=3, clock=clock)
            plane.register_breaker(bname, breakers[bname])
        plane._merge_obj(obj)
        seq = []
        for dt in (0.0, 50.0, 300.0):
            clock.t = 9000.0 + dt
            seq.append(sorted(
                (k, state, entry.value if entry else None,
                 entry.error if entry else None,
                 entry.origin if entry else None)
                for k, (state, entry) in system.cache.classify(
                    "prov", keys).items()))
        out[name] = {
            "classified": seq,
            "merged": plane.cache_merged,
            "adoptions": plane.breaker_adoptions,
            "breakers": {k: b.state for k, b in breakers.items()},
            "peers": plane.snapshot()["peers"],
            "republished": system.cache.export_fresh(),
        }
    assert out["torch"] == out["jax"]
    assert out["torch"]["merged"] == 12
    assert out["torch"]["adoptions"] == 1  # the peer's OPEN; never HALF_OPEN
    assert out["torch"]["breakers"]["device:validation"] == "half_open"
    assert out["torch"]["breakers"]["device:mutation"] == "closed"
    assert out["torch"]["republished"] == []


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_secret_written_by_one_side_loads_on_the_other(writer, tmp_path):
    """A cert Secret written by either package's SecretCertStore is
    loaded, not regenerated, by the other's FleetCertRotator: the same CA
    bytes at the same generation, no rotation, no conflict."""
    src = PKGS[writer]
    w_cluster = src.events.FakeCluster()
    w_rot = fleet_rotator(src, w_cluster, "writer", tmp_path / "w")
    w_rot.ensure()
    secret = json.loads(json.dumps(w_cluster.list(src.fleet.SECRET_GVK)[0]))
    out = {}
    for name, p in PKGS.items():
        cluster = p.events.FakeCluster()
        cluster.apply(json.loads(json.dumps(secret)))
        rot = fleet_rotator(p, cluster, "reader", tmp_path / name)
        rot.ensure()
        with open(rot.ca_path, "rb") as f:
            on_disk = f.read()
        out[name] = {"ca": rot.ca_bundle(), "on_disk": on_disk,
                     "generation": rot.cert_generation,
                     "rotations": rot.rotations,
                     "conflicts": rot.store.conflicts,
                     "stored": cluster.list(p.fleet.SECRET_GVK)}
    assert out["torch"] == out["jax"]
    assert out["torch"]["ca"] == w_rot.ca_bundle() == out["torch"]["on_disk"]
    assert (out["torch"]["generation"], out["torch"]["rotations"]) == (1, 0)
    assert out["torch"]["stored"] == [secret]


# -- KubeCluster.create and two process replicas over a mock apiserver -------


@pytest.fixture()
def mock():
    m = MockApiServer()
    try:
        yield m
    finally:
        m.close()


def test_kubecluster_create_raises_conflict_on_409(mock):
    """POST through `KubeCluster.create`: the first lands, the second gets
    the apiserver's 409 as the package's Conflict (never a replace), on
    both packages."""
    mock.register(j_control.GVK("", "v1", "Secret"), "secrets", True)
    out = {}
    for name, p in PKGS.items():
        kc = p.control.KubeCluster(base_url=mock.url, watch_timeout_seconds=5)
        obj = {"apiVersion": "v1", "kind": "Secret",
               "metadata": {"name": f"s-{name}", "namespace": "default"},
               "data": {"k": "djE="}}
        try:
            kc.create(obj)
            second = dict(obj, data={"k": "djI="})
            try:
                kc.create(second)
                raised = None
            except p.events.Conflict as e:
                raised = type(e).__name__
            got = kc.get(p.control.GVK("", "v1", "Secret"), "default",
                         f"s-{name}")
        finally:
            kc.stop()
        out[name] = (raised, got["data"])
    assert out["torch"] == out["jax"] == ("Conflict", {"k": "djE="})


def test_two_port_replicas_through_build_runner(mock, tmp_path):
    """Two `python -m gatekeeper_tpu_torch.run` wirings (build_runner on
    the CPU, distinct --pod-name) over one mock apiserver serving Secret
    and FleetState: one Secret, one CA verified over HTTPS on both ports,
    a FleetState CR per replica and each replica the other's peer."""
    from gatekeeper_tpu_torch import run as trun

    mock.register(j_control.GVK("", "v1", "Secret"), "secrets", True)
    mock.register(j_control.GVK("fleet.gatekeeper.sh", "v1alpha1",
                                "FleetState"), "fleetstates", True)
    mock.seed({"apiVersion": "v1", "kind": "Namespace",
               "metadata": {"name": "default"}})
    mock.seed(template("K8sRequiredLabels", K8S_REQ_LABELS))
    mock.seed(constraint("K8sRequiredLabels", "need-owner",
                         {"labels": ["owner"]}))
    mock.seed(config())
    mock.seed(pod("seeded"))
    runs = []
    try:
        for rid in ("replica-a", "replica-b"):
            args = trun.build_parser().parse_args([
                "--kube-url", mock.url, "--port", "0",
                "--health-addr-port", "0", "--operation", "webhook",
                "--pod-name", rid, "--fleet-namespace", "default",
                "--cert-dir", str(tmp_path / rid), "--log-level", "error"])
            cluster, runner = trun.build_runner(args, device="cpu")
            runs.append((cluster, runner))
            runner.start()
            assert runner.wait_ready(60), runner.tracker.stats()
        (_, ra), (_, rb) = runs
        assert ra.webhook.rotator.ca_bundle() == rb.webhook.rotator.ca_bundle()
        secrets = mock.store.list(j_control.GVK("", "v1", "Secret"))
        assert [s["metadata"]["name"] for s in secrets] == [SECRET_NAME]
        ctx = ssl.create_default_context(
            cadata=ra.webhook.rotator.ca_bundle().decode())
        body = json.dumps({
            "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": admission_request(labels={"app": "x"}),
        }).encode()
        for r in (ra, rb):
            resp = urllib.request.urlopen(urllib.request.Request(
                f"https://localhost:{r.webhook.port}/v1/admit", data=body,
                headers={"Content-Type": "application/json"}),
                timeout=30, context=ctx)
            assert json.loads(resp.read())["response"]["allowed"] is False
        wait_for(lambda: ra.fleet.snapshot()["peers"] == ["replica-b"]
                 and rb.fleet.snapshot()["peers"] == ["replica-a"],
                 timeout=20, msg="peer discovery through the watch")
        states = mock.store.list(j_control.GVK(
            "fleet.gatekeeper.sh", "v1alpha1", "FleetState"))
        assert sorted(s["metadata"]["name"] for s in states) == [
            "replica-a", "replica-b"]
        for r in (ra, rb):
            doc = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{r.readyz_port}/readyz", timeout=10).read())
            fl = doc["stats"]["fleet"]
            assert fl["publish_failures"] == 0 and fl["cert_generation"] == 1
            assert "device:validation" in fl["breakers"]
    finally:
        for cluster, runner in reversed(runs):
            runner.stop()
            cluster.stop()
