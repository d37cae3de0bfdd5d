"""IR feature liveness on the port's review path, on the CPU, against the
JAX package's TpuDriver on the same templates, constraints, synced pods and
review batches:

  * the live patterns (compared as pattern strings: pattern ids are not
    shared between the packages) and the token slots the mask drops
    (`columns_skipped_static`) equal TpuDriver's;
  * `review_many` results with the mask on equal those with it off and the
    JAX driver's: same results, order and messages;
  * so does a batch whose hot rows overflow the compaction window
    (R_CAP, made small here so a small batch overflows it), with and
    without canary rows in its padding;
  * the audit corpus encodes keep-all.
"""

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
)
from gatekeeper_tpu_torch.constraint import torchdriver
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.integrity import IntegrityPlane

TARGET = chip_smoke.TARGET
N_CONSTRAINTS = 24


def _client(backend, target, driver):
    client = backend(driver).new_client(target())
    for t in chip_smoke.template_docs():
        client.add_template(t)
    for c in chip_smoke.constraint_docs(N_CONSTRAINTS):
        client.add_constraint(c)
    for i in range(40):
        client.add_data(chip_smoke.make_pod(i))
    return client


def _batch(aug, seed, size=32, violating=False):
    out = []
    for j in range(size):
        i = [499, 503, 509, 521, 541, 7, 11][j % 7] if violating else 3 * j + seed
        pod = chip_smoke.make_pod(i * (j + 1), name=f"live-{seed}-{j}")
        pod["metadata"]["labels"]["release"] = f"r{seed}-{j}"
        if violating or j % 4 == 1:
            pod["metadata"]["labels"].pop("owner", None)
            pod["spec"]["containers"][0]["image"] = f"docker.io/novel{seed}x{j}"
        out.append(aug(pod))
    return out


def _results(client, batch):
    if isinstance(client._driver, TpuDriver):
        # compile the JAX driver's fused review path for this batch's
        # shapes, so the batch takes it rather than the interpreter
        assert client.warm_review_path(batch)
    return [
        [chip_smoke.result_key(r) for r in resp.by_target[TARGET].results]
        for resp in client.review_many(batch)
    ]


@pytest.fixture(scope="module")
def clients():
    t_drv, j_drv = TorchDriver(device="cpu"), TpuDriver()
    return (
        (_client(TBackend, TTarget, t_drv), t_drv),
        (_client(JBackend, JTarget, j_drv), j_drv),
    )


def _live_strings(drv):
    cs = drv._constraint_set(TARGET)
    return sorted(drv.patterns.segs(p) for p in drv._cs_live_pids(cs))


def test_live_patterns_equal_reference(clients):
    (_, t_drv), (_, j_drv) = clients
    got, want = _live_strings(t_drv), _live_strings(j_drv)
    assert got == want
    assert 0 < len(got) < t_drv.patterns.n_patterns
    rep = t_drv.ir_report(TARGET)
    assert rep.liveness["keep_all"] is False
    assert rep.liveness["patterns_total"] == t_drv.patterns.n_patterns


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_batch_equals_reference(clients, seed):
    (t_client, t_drv), (j_client, j_drv) = clients
    b0 = t_drv.liveness_batches
    got = _results(t_client, _batch(TAug, seed))
    skipped = t_drv.stats["columns_skipped_static"]
    want = _results(j_client, _batch(JAug, seed))
    assert got == want
    assert skipped == j_drv.stats["columns_skipped_static"] > 0
    assert t_drv.liveness_batches == b0 + 1
    assert sum(map(len, got)) > 0
    t_drv.liveness_enabled = False
    try:
        off = _results(t_client, _batch(TAug, seed))
        assert t_drv.stats["columns_skipped_static"] == 0
    finally:
        t_drv.liveness_enabled = True
    assert off == got


def test_audit_corpus_encodes_keep_all(clients):
    (t_client, t_drv), _ = clients
    t_client.audit()
    assert t_drv.stats["columns_skipped_static"] == 0
    assert t_drv._corpus[TARGET].skipped_static == 0


@pytest.mark.parametrize("integrity", [False, True],
                         ids=["plain", "canaries"])
def test_hot_row_overflow_equals_reference(clients, monkeypatch, integrity):
    """A chunk with more hot rows than the window is re-dispatched alone;
    under the mask (and with canary rows, which are hot rows too) its
    results stay equal to the reference's and to the unmasked batch's."""
    (t_client, t_drv), (j_client, _) = clients
    monkeypatch.setattr(torchdriver, "R_CAP", 8)
    if integrity:
        t_drv.set_integrity(IntegrityPlane())
    try:
        r0 = t_drv.stats.get("hot_redispatches", 0)
        got = _results(t_client, _batch(TAug, 9, size=40, violating=True))
        assert t_drv.stats["hot_redispatches"] > r0
        assert t_drv.stats["columns_skipped_static"] > 0
        if integrity:
            snap = t_drv.integrity.snapshot()["canary"]
            assert snap["rows"] > 0 and snap["mismatch_batches"] == 0
        t_drv.liveness_enabled = False
        off = _results(t_client, _batch(TAug, 9, size=40, violating=True))
    finally:
        t_drv.liveness_enabled = True
        t_drv.set_integrity(None)
    want = _results(j_client, _batch(JAug, 9, size=40, violating=True))
    assert got == off == want
    assert sum(map(len, got)) > 8
