"""Per-constraint cost attribution on the port, on the CPU:

  * the static cost of every constraint (`TorchDriver._static_cost`, read
    through `constraint_costs`) equals `TpuDriver._static_cost` on the same
    templates and constraints, the inventory joins and an interpreter-
    routed template included;
  * the port's CostAttributor apportions a dispatch exactly as the JAX
    one does;
  * the attributed seconds sum to the dispatch seconds the driver fed it
    (`phase_seconds["dispatch"]` of each fused dispatch), labeled by
    partition: "mono" for review_many and the audit sweep, the partition
    (default: the device) for review_many_subset.
"""

import pytest

import chip_smoke
from test_analysis import G_V007, _constraint_for, make_template
from gatekeeper_tpu.constraint import (
    Backend as JBackend,
    K8sValidationTarget as JTarget,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu.obs.attribution import CostAttributor as JCostAttributor
from gatekeeper_tpu_torch.constraint import (
    AugmentedUnstructured as TAug,
    Backend as TBackend,
    K8sValidationTarget as TTarget,
)
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.obs import CostAttributor

TARGET = chip_smoke.TARGET


def _client(backend, target, driver):
    client = backend(driver).new_client(target())
    for t in chip_smoke.template_docs():
        client.add_template(t)
    for c in chip_smoke.constraint_docs(16):
        client.add_constraint(c)
    for t in chip_smoke.uniqueness_templates():
        client.add_template(t)
    for c in chip_smoke.uniqueness_constraints():
        client.add_constraint(c)
    client.add_template(make_template("K8sWithMod", G_V007))
    client.add_constraint(_constraint_for("K8sWithMod"))
    for i in range(20):
        client.add_data(chip_smoke.make_pod(i))
    return client


def test_static_costs_equal_reference():
    t_drv, j_drv = TorchDriver(device="cpu"), TpuDriver(use_jax=False)
    _client(TBackend, TTarget, t_drv)
    _client(JBackend, JTarget, j_drv)
    got = t_drv.constraint_costs(TARGET)
    assert got == j_drv.constraint_costs(TARGET)
    assert got["K8sWithMod/k8swithmod"] == 1.0  # interpreter-routed
    assert len(set(got.values())) > 3
    cs = t_drv._constraint_set(TARGET)
    for c, p in zip(cs.constraints, cs.programs):
        assert t_drv._static_cost(p) == TpuDriver._static_cost(
            j_drv._program_for(TARGET, c)
        )


@pytest.mark.parametrize("partition", [None, 2, "p1"])
def test_apportioning_equals_reference(partition):
    entries = [("K", "a", 3.0), ("K", "b", 1.0), ("L", "c", 0.0)]
    got, want = CostAttributor(), JCostAttributor()
    for a in (got, want):
        a.note_dispatch(entries, 0.25, partition=partition)
        a.note_dispatch([("K", "a", 0.0), ("L", "c", 0.0)], 0.5)
        a.note_dispatch(entries, 0.0)  # a zero window charges nobody
    assert got.table(None) == want.table(None)
    assert got.snapshot() == want.snapshot()


def _batch(seed, size=24):
    out = []
    for j in range(size):
        pod = chip_smoke.make_pod(11 * j + seed, name=f"cost-{seed}-{j}")
        if j % 2:
            pod["metadata"]["labels"].pop("owner", None)
        out.append(TAug(pod))
    return out


def test_attributed_seconds_sum_to_dispatch_seconds():
    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv)
    att = CostAttributor()
    drv.set_attributor(att)
    fed = {}

    def note(label):
        fed[label] = fed.get(label, 0.0) + drv.stats["phase_seconds"]["dispatch"]

    keys = drv.constraint_keys(TARGET)
    client.audit()
    note("mono")
    client.review_many(_batch(0))
    note("mono")
    client.review_many_subset(_batch(1), frozenset(keys[0::2]), device=1)
    note("1")
    client.review_many_subset(_batch(2), frozenset(keys[1::2]), device=1,
                              partition=3)
    note("3")
    doc = att.table(None)
    assert att.dispatches == 4
    # the same additions in the same order: exactly the fed seconds
    assert att.total_seconds == fed["mono"] + fed["1"] + fed["3"]
    by_part = {}
    for row in doc["rows"]:
        for part, secs in row["partitions"].items():
            by_part[part] = by_part.get(part, 0.0) + secs
    assert set(by_part) == {"mono", "1", "3"}
    for part, secs in by_part.items():
        # rows are rounded to the microsecond in the table
        assert secs == pytest.approx(fed[part], abs=1e-6 * len(keys))
    assert doc["constraints"] == len(keys)
