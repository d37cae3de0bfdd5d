"""Resident vocab tables with delta upload (B7, the port's K5), on the CPU.

  * `ops.flush_deltas_plain` against the JAX package's
    `FusedAuditKernel._flush_deltas` on seeded buffers and deltas of every
    table type, casts included;
  * the staging layout K5 reads on the card (`ops.delta_plan`): every
    delta lands at an offset congruent to its destination modulo 16,
    segments stay within one block (DELTA_SEG) and cover each delta
    exactly once (more in test_torch_delta_plan.py);
  * TorchDriver("cpu") across add/remove-data churn: the sweep after the
    churn ships only the new vocab rows (the driver's upload counters),
    and its results equal the JAX TpuDriver's and the interpreter's;
  * vocab growth past the padded bucket, and a policy that swaps one
    pattern column for another of the same width: each takes a whole
    upload, and results stay equal.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gatekeeper_tpu.constraint import (
    Backend as JBackend,
    K8sValidationTarget as JTarget,
    RegoDriver as JRegoDriver,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu.engine.patterns import PatternRegistry as JPatterns
from gatekeeper_tpu.engine.tables import StrTables as JTables
from gatekeeper_tpu.flatten import Vocab as JVocab
from gatekeeper_tpu.parallel.sharding import FusedAuditKernel
from gatekeeper_tpu_torch.constraint import (
    Backend as TBackend,
    K8sValidationTarget as TTarget,
)
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.kernels import ops
from gatekeeper_tpu_torch.parallel.fused import DELTA_ROWS, pad_len

TARGET = chip_smoke.TARGET


# -- the flush ------------------------------------------------------------------

# (dtype, trailing shape, capacity, fill, delta rows, delta dtype)
TABLES = [
    (np.bool_, (), 4096, 3001, 512, np.bool_),
    (np.int32, (), 4096, 777, 1024, np.int64),
    (np.float32, (), 8192, 0, 512, np.float64),
    (np.bool_, (23,), 4096, 1001, 1536, np.bool_),
    (np.int32, (7,), 4096, 5, 512, np.int32),
    (np.float32, (3,), 4096, 3583, 512, np.float32),
]


def _seeded_tables(seed):
    r = np.random.default_rng(seed)
    out = {}
    for i, (dt, trail, cap, fill, rows, ddt) in enumerate(TABLES):
        buf = r.integers(-9, 9, (cap,) + trail).astype(dt)
        delta = r.integers(-50, 50, (rows,) + trail).astype(ddt)
        out[f"t{i}"] = (buf, delta, fill)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flush_deltas_plain_equals_jax(seed):
    tabs = _seeded_tables(seed)
    kernel = FusedAuditKernel(JPatterns(JVocab()), JTables(JVocab()))
    pending = {
        name: (jnp.asarray(buf), delta, fill, 0)
        for name, (buf, delta, fill) in tabs.items()
    }
    want = kernel._flush_deltas(pending)
    names = sorted(tabs)
    bufs = [torch.from_numpy(tabs[n][0].copy()) for n in names]
    got = ops.flush_deltas(
        bufs, [tabs[n][2] for n in names], [tabs[n][1] for n in names]
    )
    assert [b.data_ptr() for b in got] == [b.data_ptr() for b in bufs]
    for name, buf in zip(names, got):
        w = np.asarray(want[name])
        assert buf.numpy().dtype == w.dtype
        assert np.array_equal(buf.numpy(), w), name
        # rows outside the delta are untouched
        fill, rows = tabs[name][2], tabs[name][1].shape[0]
        assert np.array_equal(buf.numpy()[:fill], tabs[name][0][:fill])
        assert np.array_equal(
            buf.numpy()[fill + rows:], tabs[name][0][fill + rows:]
        )


def test_flush_deltas_rejects_overrun():
    buf = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        ops.flush_deltas([buf], [10], [np.ones(8, np.int32)])
    with pytest.raises(ValueError, match="does not fit"):
        ops.flush_deltas([buf], [0], [np.ones((2, 2), np.int32)])


@pytest.mark.parametrize("seed", [0, 1])
def test_delta_segments_layout(seed):
    tabs = _seeded_tables(seed)
    names = sorted(tabs)
    bufs = [torch.from_numpy(tabs[n][0]) for n in names]
    fills = [tabs[n][2] for n in names]
    ds = [tabs[n][1].astype(tabs[n][0].dtype) for n in names]
    # one delta past several segments
    bufs.append(torch.zeros((60_000, 3), dtype=torch.int32))
    fills.append(9)
    ds.append(np.zeros((50_000, 3), np.int32))
    rows = [b.stride(0) * b.element_size() for b in bufs]
    dsts = [b.data_ptr() + f * r for b, f, r in zip(bufs, fills, rows)]
    plan = ops.delta_plan(dsts, [d.nbytes for d in ds])
    table, starts, header = plan["table"], plan["starts"], plan["header"]
    assert header == len(table) * 16 and header % 16 == 0
    assert plan["total"] >= header + sum(d.nbytes for d in ds)
    covered = {}
    for dst, src, n in zip(table["dst"].tolist(), table["src"].tolist(),
                           table["n"].tolist()):
        i = max(j for j, d0 in enumerate(dsts) if d0 <= dst < d0 + ds[j].nbytes)
        off = dst - dsts[i]
        assert 0 < n <= ops.DELTA_SEG and (dst & 15) + n <= ops.DELTA_SEG
        assert src == starts[i] + off
        # source and destination agree modulo 16 (aligned vector moves)
        assert (src - dst) % 16 == 0
        covered.setdefault(i, []).append((off, n))
    for i, d in enumerate(ds):
        spans = sorted(covered[i])
        assert spans[0][0] == 0
        assert all(a[0] + a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert spans[-1][0] + spans[-1][1] == d.nbytes
    assert len(covered[len(ds) - 1]) > 50  # the long delta: many segments
    # staged deltas do not overlap each other or the header
    ends = sorted((s, s + d.nbytes) for s, d in zip(starts.tolist(), ds))
    assert ends[0][0] >= header
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))


def test_pad_len_leaves_room_for_one_delta():
    for n in (0, 1, 3583, 3584, 3585, 100_000, 130_560, 130_561):
        cap = pad_len(n)
        assert cap >= n + DELTA_ROWS and cap & (cap - 1) == 0 and cap >= 4096


# -- the driver across churn ------------------------------------------------------


def _clients(pods, n_constraints=12):
    t_drv, j_drv = TorchDriver(device="cpu"), TpuDriver()
    out = {}
    for name, backend, target, drv in (
        ("torch", TBackend, TTarget, t_drv),
        ("tpu", JBackend, JTarget, j_drv),
        ("rego", JBackend, JTarget, JRegoDriver()),
    ):
        client = backend(drv).new_client(target())
        for t in chip_smoke.template_docs():
            client.add_template(t)
        for c in chip_smoke.constraint_docs(n_constraints):
            client.add_constraint(c)
        for p in pods:
            client.add_data(copy.deepcopy(p))
        out[name] = client
    return out, t_drv


def _audits(clients):
    return {
        k: [chip_smoke.result_key(r)
            for r in c.audit().by_target[TARGET].results]
        for k, c in clients.items()
    }


def _apply(clients, remove=(), add=()):
    for c in clients.values():
        for p in remove:
            c.remove_data(copy.deepcopy(p))
        for p in add:
            c.add_data(copy.deepcopy(p))


def _assert_equal(res):
    assert res["torch"] == res["rego"]
    assert res["torch"] == res["tpu"]


def test_churn_takes_delta_path():
    pods = [chip_smoke.make_pod(i) for i in range(0, 1500, 5)]
    clients, drv = _clients(pods)
    res = _audits(clients)
    _assert_equal(res)
    up1 = drv.stats["upload"]
    assert up1["full_uploads"] > 0 and up1["delta_flushes"] == 0
    for rnd in range(2):
        gone = pods[rnd * 7:rnd * 7 + 7]
        new = [chip_smoke.churn_pod(100 * rnd + j) for j in range(9)]
        _apply(clients, remove=gone, add=new)
        res2 = _audits(clients)
        _assert_equal(res2)
        up = drv.stats["upload"]
        assert up["full_uploads"] == 0 and up["full_tables"] == []
        assert up["delta_flushes"] == 1
        assert up["delta_rows"] > 0 and up["delta_rows"] % DELTA_ROWS == 0
        assert up["delta_bytes"] > 0
    assert res2 != res
    # a sweep with no data change uploads nothing
    _assert_equal(_audits(clients))
    assert drv.stats["upload"]["delta_flushes"] == 0
    assert drv.stats["upload"]["full_uploads"] == 0
    # the resident tables hold exactly the host tables in their filled rows
    tabs = drv.kernel._tables_device(drv._cset[TARGET].policy)
    for name, host in drv.tables.arrays().items():
        dev = tabs[name]
        vlen = host.shape[0]
        assert dev.shape[0] == pad_len(vlen) or dev.shape[0] > vlen
        assert np.array_equal(dev[:vlen].numpy(), host.astype(dev.numpy().dtype))
        assert not dev[vlen:].numpy().any()


def test_bucket_overflow_takes_full_upload():
    pods = [chip_smoke.make_pod(i) for i in range(40)]
    clients, drv = _clients(pods, n_constraints=8)
    _assert_equal(_audits(clients))
    cap = drv.kernel._table_cache[1]["pat_member!T"].shape[0]
    fill = drv.kernel._resident["pat_member!T"].fill
    # enough new strings to run past the bucket
    new = []
    for j in range(cap - fill + 64):
        p = chip_smoke.make_pod(j, name=f"wide-{j}")
        p["metadata"]["labels"]["shard"] = f"s{j}"
        new.append(p)
        if len(new) * 2 > cap - fill + DELTA_ROWS:
            break
    _apply(clients, add=new)
    _assert_equal(_audits(clients))
    up = drv.stats["upload"]
    assert up["delta_flushes"] == 0
    assert "pat_member!T" in up["full_tables"]
    assert drv.kernel._resident["pat_member!T"].buf.shape[0] > cap


LABEL_REGO = """package {pkg}

violation[{{"msg": msg}}] {{
    input.review.object.metadata.{field}.team == "red"
    msg := "{field} team red"
}}
"""


def _field_template(kind, field):
    return {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": kind.lower()},
        "spec": {
            "crd": {"spec": {"names": {"kind": kind}}},
            "targets": [{"target": TARGET, "rego": LABEL_REGO.format(
                pkg=kind.lower(), field=field)}],
        },
    }


def _field_constraint(kind):
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind,
        "metadata": {"name": kind.lower()},
        "spec": {"match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}},
    }


def test_same_width_column_swap_takes_full_upload():
    """A policy reading one pattern column is replaced by one reading
    another column of the same width: the resident `pat_member!T` is
    keyed by its columns, so it is uploaded anew, not reused."""
    pods = []
    for i in range(30):
        p = chip_smoke.make_pod(i)
        if i % 3 == 0:
            p["metadata"]["labels"]["team"] = "red"
        if i % 4 == 0:
            p["metadata"]["annotations"]["team"] = "red"
        pods.append(p)
    drivers = {"torch": TorchDriver(device="cpu"), "tpu": TpuDriver(),
               "rego": JRegoDriver()}
    clients = {}
    for name, drv in drivers.items():
        backend, target = (TBackend, TTarget) if name == "torch" else (JBackend, JTarget)
        c = backend(drv).new_client(target())
        c.add_template(_field_template("TeamLabel", "labels"))
        c.add_template(_field_template("TeamAnnotation", "annotations"))
        c.add_constraint(_field_constraint("TeamLabel"))
        for p in pods:
            c.add_data(copy.deepcopy(p))
        clients[name] = c
    t_drv = drivers["torch"]
    res1 = _audits(clients)
    _assert_equal(res1)
    cols1 = t_drv._cset[TARGET].policy.cols["pat_member"]
    for c in clients.values():
        c.remove_constraint(_field_constraint("TeamLabel"))
        c.add_constraint(_field_constraint("TeamAnnotation"))
    res2 = _audits(clients)
    _assert_equal(res2)
    cols2 = t_drv._cset[TARGET].policy.cols["pat_member"]
    assert len(cols1) == len(cols2) and cols1 != cols2
    assert "pat_member!T" in t_drv.stats["upload"]["full_tables"]
    assert len(res1["rego"]) == 10 and len(res2["rego"]) == 8
    resident = t_drv.kernel._resident["pat_member!T"]
    member = np.asarray(t_drv.patterns.member)[cols2].T
    assert np.array_equal(resident.buf[:resident.fill].numpy(), member)
