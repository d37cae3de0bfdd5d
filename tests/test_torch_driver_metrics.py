"""The port's driver metric series (TorchDriver with a MetricsRegistry)
against the JAX package's TpuDriver on the CPU, on one seeded policy and
corpus (tests/test_torch_driver.py's): an audit sweep, one review batch,
and a registry wired late, after analysis, as the Runner wires it. Both
must give the same series names, tag sets and counter values, the same
number of driver_phase_seconds observations per path, and the verdict
gauges; every difference is pinned beside the JAX value, and the list of
reference series the port leaves out is pinned."""

import functools

import pytest

import chip_smoke
import test_torch_driver as base
from gatekeeper_tpu.constraint import (
    AugmentedUnstructured as JAug,
    Backend as JBackend,
    K8sValidationTarget as JTarget,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu.metrics import MetricsRegistry as JRegistry
from gatekeeper_tpu_torch.constraint import (
    AugmentedUnstructured as TAug,
    Backend as TBackend,
    K8sValidationTarget as TTarget,
)
from gatekeeper_tpu_torch.constraint import torchdriver
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.metrics import MetricsRegistry as TRegistry

TARGET = chip_smoke.TARGET

# the reference driver's and jit kernel's series with no counterpart site
# in the port (torchdriver's docstring)
LEFT_OUT = ("driver_cold_batches_total", "program_cache_total",
            "program_compile_seconds")

# the reference's phase names and the port's (torchdriver's docstring)
JAX_PHASES = {"flatten_encode", "device_dispatch", "render"}
PORT_PHASES = {"policy", "encode", "stage", "row_features", "dispatch",
               "decode", "render"}


def _family(key: str) -> str:
    return key.split("{")[0]


def _tags(key: str):
    inner = key.partition("{")[2].rstrip("}")
    return dict(p.split("=", 1) for p in inner.split(",")) if inner else {}


def _pair(jax_reg=None, torch_reg=None):
    """(JAX client and driver, port client and driver) over the seeded
    policy and 300-pod corpus."""
    j_drv = TpuDriver(metrics=jax_reg)
    t_drv = TorchDriver(device="cpu", metrics=torch_reg)
    return ((base._client(JBackend, JTarget, j_drv), j_drv),
            (base._client(TBackend, TTarget, t_drv), t_drv))


def _sweep_and_batch(jax, port, seed=0):
    """One audit sweep, then one review batch, on each side. Both warm the
    review path first (the JAX driver answers a cold batch on the
    interpreter)."""
    (j_client, _), (t_client, _) = jax, port
    j_client.audit()
    t_client.audit()
    j_batch = base._batch(JAug, seed)
    t_batch = base._batch(TAug, seed)
    assert j_client.warm_review_path(j_batch)
    assert t_client.warm_review_path(t_batch)
    j_client.review_many(j_batch)
    t_client.review_many(t_batch)


@pytest.fixture(scope="module")
def wired():
    regs = (JRegistry(), TRegistry())
    jax, port = _pair(*regs)
    _sweep_and_batch(jax, port)
    return regs[0].snapshot(), regs[1].snapshot(), jax, port


def test_counters_and_gauges_equal(wired):
    """Every counter and gauge of the port equals the JAX driver's, name,
    tags and value; the JAX driver's extra ones are the jit kernel's
    (left out) and one standing divergence, pinned below."""
    j_snap, t_snap, _, _ = wired
    for kind in ("counters", "gauges"):
        j, t = j_snap[kind], t_snap[kind]
        assert {_family(k) for k in t} - {_family(k) for k in j} == set()
        for key, value in t.items():
            if key == 'padding_waste_rows_total{path="webhook"}':
                continue  # the warm's staging, pinned below
            assert j.get(key) == value, key
        extra = {k for k in j if k not in t}
        assert {_family(k) for k in extra} <= set(LEFT_OUT)
    c = t_snap["counters"]
    assert c['driver_pairs_total{path="audit",route="compiled"}'] > 0
    assert c['driver_pairs_total{path="webhook",route="compiled"}'] > 0
    assert c['driver_render_total{route="host"}'] > 0
    assert c['padding_waste_rows_total{path="audit"}'] > 0
    assert any(k.startswith("template_vectorization")
               for k in t_snap["gauges"])


def test_phase_seconds_observations_per_path(wired):
    """driver_phase_seconds: one observation per evaluation and phase on
    both; the same count per path, under each side's phase names."""
    j_snap, t_snap, _, _ = wired

    def per_path(snap, want_phases):
        out = {}
        for key, d in snap["distributions"].items():
            if _family(key) != "driver_phase_seconds":
                continue
            tags = _tags(key)
            assert set(tags) == {"path", "phase"}
            assert tags["phase"].strip('"') in want_phases
            out.setdefault(tags["path"], set()).add(d["count"])
        return out

    j, t = per_path(j_snap, JAX_PHASES), per_path(t_snap, PORT_PHASES)
    assert t == j == {'"audit"': {1}, '"webhook"': {1}}
    assert {_tags(k)["phase"].strip('"') for k in t_snap["distributions"]
            if _family(k) == "driver_phase_seconds"} == PORT_PHASES


def test_warm_dispatch_is_the_one_staging_difference(wired):
    """Standing divergence: the JAX warm path stages and dispatches a
    throwaway batch of the live batch's shape to compile its jit; the
    port's compiles nothing and stages nothing. So the JAX driver has one
    more webhook batch_occupancy_percent observation and twice the
    webhook padding waste; the audit path's are equal."""
    j_snap, t_snap, _, _ = wired
    jd, td = j_snap["distributions"], t_snap["distributions"]
    audit = 'batch_occupancy_percent{path="audit"}'
    hook = 'batch_occupancy_percent{path="webhook"}'
    assert jd[audit] == td[audit]
    assert (jd[hook]["count"], td[hook]["count"]) == (2, 1)
    assert jd[hook]["min"] == jd[hook]["max"] == td[hook]["max"]
    waste = 'padding_waste_rows_total{path="webhook"}'
    jw, tw = j_snap["counters"][waste], t_snap["counters"][waste]
    assert tw > 0 and jw == 2 * tw


def test_reference_series_left_out_are_pinned(wired):
    """Exactly these reference series have no counterpart site in the
    port: the jit kernel's cache and compile series, and the cold-batch
    counter (the port serves no batch around a cold kernel)."""
    doc = " ".join(torchdriver.__doc__.split())
    assert all(f"`{name}`" in doc.partition("Not emitted")[2]
               for name in LEFT_OUT)
    j_snap, t_snap, _, _ = wired
    j_fams = {_family(k) for kind in j_snap.values() for k in kind}
    t_fams = {_family(k) for kind in t_snap.values() for k in kind}
    assert j_fams - t_fams == {"program_cache_total",
                               "program_compile_seconds"}
    assert not t_fams & set(LEFT_OUT)


def test_cold_batch_counter_is_the_reference_s_alone():
    """A cold JAX review path answers the batch on the interpreter and
    counts driver_cold_batches_total; the port dispatches the same batch
    on its fused path and has no such counter."""
    jreg, treg = JRegistry(), TRegistry()
    (j_client, _), (t_client, _) = _pair(jreg, treg)
    j_client.review_many(base._batch(JAug, 1))
    t_client.review_many(base._batch(TAug, 1))
    assert jreg.snapshot()["counters"]["driver_cold_batches_total"] == 1
    t_counters = treg.snapshot()["counters"]
    assert "driver_cold_batches_total" not in t_counters
    assert t_counters['driver_pairs_total{path="webhook",route="compiled"}'] > 0


def test_late_set_metrics_reexports_verdicts_and_wires_the_store():
    """Wired after analysis, as the Runner does: the verdict gauges
    already analysed are exported alike, a store without a registry gets
    this one (one with its own keeps it), and the series that follow
    equal the JAX driver's."""

    class Store:
        def __init__(self, metrics=None):
            self.metrics = metrics

        def note_miss(self):
            pass

        def attest(self):
            pass

    jax, port = _pair()
    (_, j_drv), (_, t_drv) = jax, port
    for drv in (j_drv, t_drv):
        drv._constraint_set(TARGET)
    jreg, treg = JRegistry(), TRegistry()
    own = TRegistry()
    j_drv.program_store, t_drv.program_store = Store(), Store()
    j_drv.set_metrics(jreg)
    t_drv.set_metrics(treg)
    assert t_drv.metrics is treg and t_drv.program_store.metrics is treg
    assert j_drv.program_store.metrics is jreg
    j_gauges = jreg.snapshot()["gauges"]
    t_gauges = treg.snapshot()["gauges"]
    assert t_gauges == j_gauges
    assert sum(k.startswith("template_vectorization") for k in t_gauges) == 8
    kept = Store(own)
    t_drv.program_store = kept
    t_drv.set_metrics(treg)
    assert kept.metrics is own
    j_drv.program_store = t_drv.program_store = None
    jax[0].audit()
    port[0].audit()
    assert treg.snapshot()["counters"] == {
        k: v for k, v in jreg.snapshot()["counters"].items()
        if _family(k) not in LEFT_OUT}


def _counters(reg, prefix):
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith(prefix)}


def test_hot_redispatch_counted_alike(monkeypatch):
    """A compaction window smaller than a chunk's hot rows reruns the
    chunk alone on both: driver_hot_redispatch_total and the sweep's
    pairs are equal."""
    jreg, treg = JRegistry(), TRegistry()
    (j_client, j_drv), (t_client, t_drv) = _pair(jreg, treg)
    monkeypatch.setattr(torchdriver, "R_CAP", 16)
    monkeypatch.setattr(j_drv.kernel, "dispatch_need_all", functools.partial(
        j_drv.kernel.dispatch_need_all, r_cap=16))
    j_res = base._keys(j_client.audit().by_target[TARGET].results)
    t_res = base._keys(t_client.audit().by_target[TARGET].results)
    assert t_res == j_res
    got = _counters(treg, "driver_")
    assert got["driver_hot_redispatch_total"] >= 1
    assert got == {k: v for k, v in _counters(jreg, "driver_").items()}
    assert t_drv.stats["hot_redispatches"] == got[
        "driver_hot_redispatch_total"]


def test_render_errors_counted_alike(monkeypatch):
    """A compiled render that raises goes to the interpreter on both, and
    is counted in driver_render_errors_total the same number of times;
    the results stay equal."""
    from gatekeeper_tpu.engine import render as jrender
    from gatekeeper_tpu_torch.engine import render as trender

    def boom(self, *a, **kw):
        raise RuntimeError("plan evaluation failed")

    jreg, treg = JRegistry(), TRegistry()
    (j_client, _), (t_client, t_drv) = _pair(jreg, treg)
    monkeypatch.setattr(jrender.RenderSet, "render_row", boom)
    monkeypatch.setattr(trender.RenderSet, "render_row", boom)
    j_res = base._keys(j_client.audit().by_target[TARGET].results)
    t_res = base._keys(t_client.audit().by_target[TARGET].results)
    assert t_res == j_res
    got = _counters(treg, "driver_")
    assert got["driver_render_errors_total"] > 0
    assert got["driver_render_total{route=\"host\"}"] == 0
    assert got == _counters(jreg, "driver_")
    assert t_drv.stats["render_errors"] == got["driver_render_errors_total"]


def test_render_cache_evictions_counted_and_pinned():
    """A render cache smaller than a sweep's pairs: the first sweep evicts
    the same entries on both. On the second, the JAX driver evicts the
    entries it is about to read and misses every pair, where the port
    looks every pair up first (ROADMAP §C, render cache): pinned with the
    JAX value beside it."""
    jreg, treg = JRegistry(), TRegistry()
    (j_client, j_drv), (t_client, t_drv) = _pair(jreg, treg)
    j_drv.render_cache_max = t_drv.render_cache_max = 50
    key = "driver_render_cache_evictions_total"
    j_client.audit()
    t_client.audit()
    first = treg.snapshot()["counters"][key]
    pairs = t_drv.stats["host_rendered_pairs"]
    assert first == jreg.snapshot()["counters"][key] == pairs - 50 > 0
    assert t_drv.stats["render_cache_evictions"] == first
    j_client.audit()
    t_client.audit()
    j_second = jreg.snapshot()["counters"][key] - first
    t_second = treg.snapshot()["counters"][key] - first
    assert (j_second, t_second) == (pairs, pairs - 50)
    assert t_drv.stats["render_cache_hits"] == 50


def test_runner_exports_the_driver_series():
    """The port's Runner late-wires its registry into TorchDriver: the
    verdict gauges of templates analysed before it, and after a sweep the
    pair counters and the dispatch phase, reach its /metrics text (the
    Runner is built, not started: the wiring is in its constructor)."""
    from gatekeeper_tpu_torch.control import FakeCluster, Runner

    client = TBackend(TorchDriver(device="cpu")).new_client(TTarget())
    for t in chip_smoke.template_docs():
        client.add_template(t)
    cluster = FakeCluster()
    for c in chip_smoke.constraint_docs(base.N_CONSTRAINTS):
        client.add_constraint(c)
    for i in base.POD_IDS[:60]:
        client.add_data(chip_smoke.make_pod(i))
    runner = Runner(cluster, client, TARGET, audit_interval=3600.0)
    try:
        gauges = runner.metrics.snapshot()["gauges"]
        assert gauges[
            'template_vectorization{kind="K8sRequiredLabels",'
            'verdict="VECTORIZED"}'] == 1
        client.audit()
        text = runner.metrics.prometheus_text()
        assert chip_smoke._metric(text, "template_vectorization") == 8
        assert chip_smoke._metric(text, "driver_pairs_total",
                                  route="compiled") > 0
        assert chip_smoke._metric(text, "driver_phase_seconds_count",
                                  phase="dispatch", path="audit") == 1
    finally:
        runner.stop()


def test_sweep_path_label_follows_the_corpus():
    """`path` labels the corpus, as in the reference (tpudriver.py:2454):
    a sweep of the synced cache is path="audit"; a discovery sweep pages
    its listed objects through review_many, so its dispatches are
    path="webhook" (what `python -m gatekeeper_tpu_torch.run` records by
    default)."""
    from gatekeeper_tpu_torch.audit import AuditManager, InMemorySink
    from gatekeeper_tpu_torch.control import FakeCluster

    reg = TRegistry()
    drv = TorchDriver(device="cpu", metrics=reg)
    client = base._client(TBackend, TTarget, drv)
    cluster = FakeCluster()
    for i in base.POD_IDS[:40]:
        pod = chip_smoke.make_pod(i)
        cluster.apply(pod)
        ns = pod["metadata"]["namespace"]
        cluster.apply({"apiVersion": "v1", "kind": "Namespace",
                       "metadata": {"name": ns}})

    def dispatches():
        dists = reg.snapshot()["distributions"]
        return {p: dists.get(
            f'driver_phase_seconds{{path="{p}",phase="dispatch"}}',
            {"count": 0})["count"] for p in ("audit", "webhook")}

    AuditManager(client, TARGET, sink=InMemorySink(),
                 audit_interval=3600).audit()
    assert dispatches() == {"audit": 1, "webhook": 0}
    AuditManager(client, TARGET, sink=InMemorySink(), audit_interval=3600,
                 audit_from_cache=False, cluster=cluster,
                 audit_chunk_size=16).audit()
    n_ns = len({f"ns{i % 23}" for i in base.POD_IDS[:40]})
    pages = -(-40 // 16) + -(-n_ns // 16)  # one dispatch per page and kind
    assert dispatches() == {"audit": 1, "webhook": pages}
