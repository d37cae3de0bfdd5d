#!/usr/bin/env python3
"""Smoke run of gatekeeper_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each on stdout:

  card     the card's name and power limit (nvidia-smi);
  build    nvcc builds every kernel of the path from csrc/ into
           build/gatekeeper_tpu_torch/ (one nvcc per source, in parallel);
  parity   2,000 pods x 50 constraints and 4 review batches of 64 on
           TorchDriver("cuda"): results identical to the port's own
           interpreter driver (RegoDriver);
  full     the north-star deployment (100,000 pods x 500 constraints): one
           audit sweep (4 chunks of 32,768 rows) and 8 admission
           micro-batches of 256 reviews through Client.review_many, with
           the time of each phase (encode, stage, dispatch, decode,
           render); every kernel's launch counter must be > 0 over that
           run, and a sample of its reviews must match the interpreter;
  kernels  each kernel against its plain torch version on inputs the full
           run gave it (exact equality: every output is bool or int), with
           the kernel's device time (torch.profiler), the wrapper's wall
           time per call, the plain version's and, where one PyTorch call
           computes the same function, that call's; and the least time
           the card needs for the bytes and operations this input needs;
  variants each kernel against its plain version on seeded random inputs
           that reach the code paths the in-repo policy does not (K1's
           namespace, scope and selector clauses over many spec rows,
           EGroup sum/max, int32/float32 values, g1/g01 axes, overlay
           slabs, a hot-row window smaller than the hot rows);
  profile  device-busy against wall seconds (torch.profiler, CUDA
           activity) for a second, warm-corpus audit sweep and one more
           review batch, after the counted run.

The line before the last is the kernel table as one JSON object; the last
line is {"ok": true, "device": {...}}. Any failing phase raises, and the
script exits nonzero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TARGET = "admission.k8s.gatekeeper.sh"
POLICIES = os.path.join(ROOT, "deploy", "policies")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM peak outside the tensor cores (67 TFLOP/s float32, NVIDIA data
# sheet); the integer and boolean work of these kernels runs on the same
# pipes, so no faster
SCALAR_OPS_PER_S = 67e12

# constraint parameters per in-repo template, cycled like bench.build_client
PARAMS = {
    "K8sRequiredLabels": [
        {"labels": [{"key": "app"}]},
        {"labels": [{"key": "app"}, {"key": "owner"}]},
    ],
    "K8sAllowedRepos": [
        {"repos": ["nginx", "gcr.io/prod"]},
        {"repos": ["nginx", "gcr.io/prod", "quay.io/infra"]},
    ],
    "K8sBlockNodePort": [None],
    "K8sPSPPrivileged": [None],
    "GTRequiredAnnotations": [
        {"annotations": ["seccomp.security.alpha.kubernetes.io/pod"]},
    ],
    "GTDeniedImageRegistries": [
        {"registries": ["docker.io/"]},
        {"registries": ["docker.io/", "index.docker.io/"]},
    ],
    "GTNoLatestTag": [None],
    "GTMemoryLimitCeiling": [{"maxMemory": "8Gi"}, {"maxMemory": "16Gi"}],
}

# (python module path, TPU kernel it replaces) per kernel wrapper
KERNELS = {
    "match_matrix": ("gatekeeper_tpu_torch/kernels/csrc/match.cu",
                     "gatekeeper_tpu/engine/matchkernel.py:106"),
    "slab_gather": ("gatekeeper_tpu_torch/kernels/csrc/slab.cu",
                    "gatekeeper_tpu/parallel/sharding.py:771"),
    "egroup": ("gatekeeper_tpu_torch/kernels/csrc/group.cu",
               "gatekeeper_tpu/engine/exprs.py:510"),
    "need_tail": ("gatekeeper_tpu_torch/kernels/csrc/need.cu",
                  "gatekeeper_tpu/parallel/sharding.py:852"),
}


# the __global__ functions each wrapper launches
KERNEL_FUNCS = {
    "match_matrix": ("match_kernel",),
    "slab_gather": ("slab_kernel",),
    "egroup": ("egroup_kernel",),
    "need_tail": ("need_rows_kernel", "compact_kernel", "pack_kernel"),
}


def template_docs():
    """The 8 in-repo ConstraintTemplates (deploy/policies)."""
    import yaml

    out = []
    for name in ("reference-library.yaml", "templates.yaml"):
        with open(os.path.join(POLICIES, name)) as f:
            out.extend(
                d for d in yaml.safe_load_all(f)
                if d and d.get("kind") == "ConstraintTemplate"
            )
    return out


def constraint_docs(n: int):
    """n constraints cycled over the templates, parameters varied."""
    kinds = [t["spec"]["crd"]["spec"]["names"]["kind"] for t in template_docs()]
    out = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        variants = PARAMS[kind]
        params = variants[(i // len(kinds)) % len(variants)]
        spec = {"match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}}
        if params is not None:
            spec["parameters"] = params
        out.append({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind,
            "metadata": {"name": f"c{i}"},
            "spec": spec,
        })
    return out


def make_pod(i: int, max_containers: int = 16, name: str = None):
    """A synthetic Pod in the shape of bench.make_pod: 1..max_containers
    containers, labels, seccomp/apparmor annotations, hostPath volumes on
    a third of pods; about 1% violate some template."""
    labels = {"app": f"svc{i % 17}", "owner": f"team{i % 5}"}
    if i % 499 == 0:
        labels.pop("owner")
    if i % 37 == 0:
        labels.update({f"k{j}": f"v{j}" for j in range(i % 9)})
    image = "nginx:1.25" if i % 503 else "docker.io/evil:latest"
    n_ctr = 1 + (i % max_containers)
    containers = []
    for c in range(n_ctr):
        ctr = {
            "name": f"c{c}",
            "image": image if c == 0 else "nginx:1.25",
            "resources": {"limits": {
                "cpu": "1", "memory": "12Gi" if i % 509 == 0 else "2Gi",
            }},
        }
        if c == 0 and i % 521 == 0:
            ctr["securityContext"] = {"privileged": True}
        containers.append(ctr)
    ann = {
        "seccomp.security.alpha.kubernetes.io/pod": "runtime/default",
    }
    if i % 541 == 0:
        ann = {}
    for c in range(n_ctr):
        ann[f"container.apparmor.security.beta.kubernetes.io/c{c}"] = (
            "runtime/default"
        )
    meta = {
        "name": name or f"p{i}",
        "namespace": f"ns{i % 23}",
        "labels": labels,
        "annotations": ann,
    }
    spec = {"containers": containers}
    if i % 3 == 0:
        spec["volumes"] = [
            {"name": "data", "hostPath": {"path": "/var/log/app"}},
            {"name": "cache", "emptyDir": {}},
        ]
        containers[0]["volumeMounts"] = [
            {"name": "data", "mountPath": "/data", "readOnly": True},
        ]
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta, "spec": spec}


def review_batch(seed: int, size: int):
    """An admission micro-batch: fresh pods carrying strings the audit
    corpus never interned (names, labels, images), so the review path
    runs its vocabulary overlay."""
    from gatekeeper_tpu_torch.constraint import AugmentedUnstructured

    out = []
    for j in range(size):
        i = 1_000_000 + seed * size + j
        pod = make_pod(i, name=f"admit-{seed}-{j}")
        pod["metadata"]["labels"]["release"] = f"r{seed}-{j}"
        if j % 5 == 0:
            pod["spec"]["containers"][0]["image"] = f"docker.io/novel{seed}x{j}"
        out.append(AugmentedUnstructured(pod))
    return out


def build_client(driver, n_pods: int, n_constraints: int):
    from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget

    client = Backend(driver).new_client(K8sValidationTarget())
    for t in template_docs():
        client.add_template(t)
    for c in constraint_docs(n_constraints):
        client.add_constraint(c)
    for i in range(n_pods):
        client.add_data(make_pod(i))
    return client


def result_key(r):
    obj = r.review.get("object") if isinstance(r.review, dict) else None
    name = (obj or {}).get("metadata", {}).get("name")
    return (
        r.constraint["kind"], r.constraint["metadata"]["name"], name, r.msg,
        json.dumps(r.metadata, sort_keys=True, default=str),
        r.enforcement_action,
    )


def _keys(results):
    return [result_key(r) for r in results]


# -- timing -------------------------------------------------------------------


def _time_ms(fn, reps: int = 10) -> float:
    """Wall ms per call of back-to-back calls, between CUDA events: the
    host's cost of issuing the call whenever that exceeds the device's."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_time_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def _device_ms(fn, kernels=None, reps: int = 10) -> float:
    """Device ms per call (torch.profiler, CUDA activity): the summed
    execution time of the kernels whose names start with one of
    `kernels`, or of all device activity when `kernels` is None. Host
    issue time does not enter it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        parts = (e.key or "").split("<")[0].split("(")[0].split()
        name = parts[-1] if parts else ""
        if kernels is None or name in kernels:
            us += _device_time_us(e)
    if us <= 0.0:
        raise AssertionError(f"profiler saw no device time for {kernels}")
    return us / 1e3 / reps


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# -- phases -------------------------------------------------------------------


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(out, flush=True)
    return out


def phase_build():
    from gatekeeper_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    dt = time.perf_counter() - t0
    # ptxas register / shared-memory report of what was compiled
    with open(build.BUILD_DIR / "ptxas.txt", "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}.cu\n{log}\n")
    print(json.dumps({"phase": "build", "seconds": dt,
                      "built": sorted(logs)}), flush=True)


def phase_parity(device: str, n_pods: int = 2000, n_constraints: int = 50,
                 n_batches: int = 4, batch: int = 64):
    from gatekeeper_tpu_torch.constraint import RegoDriver
    from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver

    t0 = time.perf_counter()
    drv = TorchDriver(device)
    port = build_client(drv, n_pods, n_constraints)
    ref = build_client(RegoDriver(), n_pods, n_constraints)
    got = port.audit().by_target[TARGET].results
    want = ref.audit().by_target[TARGET].results
    if _keys(got) != _keys(want):
        raise AssertionError(
            f"parity: audit differs ({len(got)} vs {len(want)} results)"
        )
    audit_stats = dict(drv.stats)
    n_review = 0
    for b in range(n_batches):
        objs = review_batch(900 + b, batch)
        g = [_keys(r.by_target[TARGET].results) for r in port.review_many(objs)]
        w = [_keys(r.by_target[TARGET].results) for r in ref.review_many(objs)]
        if g != w:
            raise AssertionError(f"parity: review batch {b} differs")
        n_review += sum(len(x) for x in g)
    print(json.dumps({
        "phase": "parity", "pods": n_pods, "constraints": n_constraints,
        "audit_results": len(got), "review_results": n_review,
        "compiled_pairs": audit_stats["compiled_pairs"],
        "interp_pairs": audit_stats["interp_pairs"],
        "seconds": time.perf_counter() - t0,
    }), flush=True)


class Recorder:
    """Keeps the inputs of kernel calls on the main path (a few per
    kernel, distinct by their kind) for the kernel phase."""

    def __init__(self, ops):
        self.ops = ops
        self.calls = {name: {} for name in KERNELS}
        self.originals = {name: getattr(ops, name) for name in KERNELS}

    def install(self):
        for name, fn in self.originals.items():
            setattr(self.ops, name, self._wrap(name, fn))

    def remove(self):
        for name, fn in self.originals.items():
            setattr(self.ops, name, fn)

    def _wrap(self, name, fn):
        def rec(*args, **kw):
            key = _variant(name, args, kw)
            if key not in self.calls[name]:
                self.calls[name][key] = (args, kw)
            return fn(*args, **kw)

        return rec


def _variant(name, args, kw):
    if name == "slab_gather":
        tab, ids = args[0], args[1]
        ov = args[2] if len(args) > 2 else kw.get("ov")
        return (str(tab.dtype), tuple(tab.shape[1:]), ov is not None)
    if name == "egroup":
        return (args[4], args[7], str(args[3].dtype))
    if name == "need_tail":
        return (tuple(args[2].shape), args[6])
    return tuple(args[1]["group_id"].shape)


def phase_full(device: str, n_pods: int = 100_000, n_constraints: int = 500,
               n_batches: int = 8, batch: int = 256):
    import torch
    from gatekeeper_tpu_torch.constraint import RegoDriver
    from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
    from gatekeeper_tpu_torch.kernels import ops

    t0 = time.perf_counter()
    drv = TorchDriver(device)
    client = build_client(drv, n_pods, n_constraints)
    ingest_s = time.perf_counter() - t0
    rec = Recorder(ops)
    rec.install()
    ops.reset_launches()
    try:
        t1 = time.perf_counter()
        results = client.audit().by_target[TARGET].results
        audit_s = time.perf_counter() - t1
        audit_stats = dict(drv.stats)
        audit_launches = dict(ops.LAUNCHES)
        batch_stats = []
        batch_objs = []
        review_results = []
        for b in range(n_batches):
            objs = review_batch(b, batch)
            t2 = time.perf_counter()
            resps = client.review_many(objs)
            st = dict(drv.stats)
            st["seconds"] = time.perf_counter() - t2
            batch_stats.append(st)
            batch_objs.append(objs)
            review_results.append(
                [_keys(r.by_target[TARGET].results) for r in resps]
            )
        launches = dict(ops.LAUNCHES)
    finally:
        rec.remove()
    if torch.device(device).type == "cuda":
        missing = [k for k, v in launches.items() if v <= 0]
        if missing:
            raise AssertionError(f"full: kernels never launched: {missing}")
    # correctness by the repo's own means: a sample of reviews (every
    # violating pod among the first 2,000 rows, a few clean ones, one
    # review batch) equals the interpreter driver's answer
    ref = build_client(RegoDriver(), 0, n_constraints)
    by_pod = {}
    for r in results:
        by_pod.setdefault(r.review["object"]["metadata"]["name"], []).append(r)
    bad = sorted(
        int(k[1:]) for k in by_pod if k.startswith("p") and int(k[1:]) < 2000
    )
    sample = bad[:12] + [i for i in range(1, 40) if f"p{i}" not in by_pod][:4]
    from gatekeeper_tpu_torch.constraint import AugmentedUnstructured

    for i in sample:
        obj = make_pod(i)
        want = _keys(ref.review(AugmentedUnstructured(obj)).by_target[TARGET].results)
        got = sorted(_keys(by_pod.get(f"p{i}", [])))
        if sorted(want) != got:
            raise AssertionError(f"full: audit of p{i} differs from interp")
    want_b = [
        _keys(r.by_target[TARGET].results)
        for r in ref.review_many(batch_objs[0][:32])
    ]
    if want_b != review_results[0][:32]:
        raise AssertionError("full: review batch 0 differs from interp")
    n_viol_pods = len(by_pod)
    print(json.dumps({
        "phase": "full", "pods": n_pods, "constraints": n_constraints,
        "ingest_seconds": ingest_s, "audit_seconds": audit_s,
        "audit_results": len(results), "violating_pods": n_viol_pods,
        "audit_stats": audit_stats, "audit_launches": audit_launches,
        "batches": [
            {"seconds": s["seconds"], "results": s["n_results"],
             "compiled_pairs": s["compiled_pairs"],
             "phase_seconds": s["phase_seconds"]}
            for s in batch_stats
        ],
        "launches": launches, "sample_checked": len(sample),
    }, default=float), flush=True)
    return rec, launches, client, drv


def _match_needs(ms, fb, n: int):
    """-> (bytes, operations) K1 needs for this staged spec set: the spec
    arrays and the output whole, and a review feature array only where
    some spec row reads it (namespace ids and the `always` flags only
    under namespaces/excludedNamespaces/namespaceSelector, label arrays
    only under a selector with a live entry). Operations count live
    entries only: valid kind rows, -1-free namespace ids, matchLabels
    pairs and matchExpressions that are set."""
    import numpy as np

    from gatekeeper_tpu_torch.engine.matchspec import (
        OP_EXISTS, OP_IN, OP_NOT_EXISTS, OP_NOT_IN, SCOPE_CLUSTER,
        SCOPE_NAMESPACED, WILDCARD,
    )

    h = {k: v.cpu().numpy() for k, v in ms.items()}
    u = h["kind_rows"].shape[0]
    ml = fb["obj_labels"].shape[1]
    ml2 = fb["nssel_labels"].shape[1]
    label_ops = (OP_IN, OP_NOT_IN, OP_EXISTS, OP_NOT_EXISTS)

    def live(pre, r):
        """(matchLabels pairs, label-reading expressions) set in row r of
        a selector that is not invalid."""
        if h[pre + "_invalid"][r]:
            return 0, 0
        p_ = int((h[pre + "_ml"][r, :, 0] != -1).sum())
        e_ = int(np.isin(h[pre + "_expr"][r, :, 1], label_ops).sum())
        return p_, e_

    def sel_ops(p_, e_, width, vals):
        return 2 * p_ * width + e_ * (2 * width + vals)

    read = {"group_id", "kind_id"}
    ops = 0
    for r in range(u):
        g = h["kind_rows"][r, :, 0]
        k_live = int((((g != -1) & (g > -3)) | (g == WILDCARD)).sum())
        row = 6 * k_live + 16
        for has, ids in (("ns_has", "ns_ids"), ("excl_has", "excl_ids")):
            if h[has][r]:
                read |= {"ns_name_id", "kind_defined", "is_ns",
                         "has_namespace"}
                row += 2 * int((h[ids][r] != -1).sum())
        if h["scope"][r] in (SCOPE_NAMESPACED, SCOPE_CLUSTER):
            read.add("has_namespace")
        if h["nssel_has"][r]:
            read |= {"kind_defined", "is_ns", "has_namespace",
                     "nssel_defined", "nssel_empty"}
            p_, e_ = live("nssel", r)
            if p_ or e_:
                read |= {"nssel_labels", "obj_labels", "old_labels",
                         "obj_present", "old_present"}
                v_ = h["nssel_expr_vals"].shape[2]
                # the plain candidate, or the object/oldObject 4-case
                row += sel_ops(p_, e_, ml2, v_) + 2 * sel_ops(p_, e_, ml, v_)
        p_, e_ = live("lab", r)
        if p_ or e_:
            read |= {"obj_labels", "old_labels", "obj_present", "old_present"}
            row += 2 * sel_ops(p_, e_, ml, h["lab_expr_vals"].shape[2])
        ops += n * row
    b = _nbytes(*ms.values(), *(fb[k] for k in sorted(read))) + u * n
    return b, ops


def _bound(name, args, out):
    """-> (bound ms, "bytes" | "operations", bytes ms, operations ms).

    Bytes: what the function must move for this input — inputs read once,
    the output written once, data-dependent parts only as far as this
    run's data needs them — over the card's memory rate. Operations: the
    integer/boolean operations it does on this input (comparisons,
    selects, moves; counted per live element) over the card's peak rate
    outside the tensor cores. The bound is the larger of the two."""
    import torch

    if name == "match_matrix":
        ms, fb = args
        b, ops = _match_needs(ms, fb, out.shape[1])
    elif name == "slab_gather":
        tab, ids = args[0], args[1]
        # base rows below v_base and overlay rows above it alike: each
        # distinct row of width T is read once
        rows = torch.unique(ids).numel()
        b = _nbytes(ids, out) + rows * tab.shape[1] * tab.element_size()
        ops = 3 * out.numel()  # clamp, select, move per element
    elif name == "egroup":
        idx0, idx1, mask, val, axis = args[:5]
        idx = {"g0": (idx0,), "g1": (idx1,), "g01": (idx0, idx1)}[axis]
        # the mask whole; ids and values only where a token is live
        n_live = int(mask.sum())
        b = _nbytes(mask, out) + n_live * (
            sum(t.element_size() for t in idx) + val.element_size()
        )
        ops = 2 * mask.numel() + 6 * n_live + 3 * out.numel()
    else:
        match_u, spec_map, viol, compiled, row_fb, n_valid = args[:6]
        r_cap = args[6]
        matched = match_u[spec_map.long(), :n_valid]
        n_matched = int(matched.sum())
        b = (
            _nbytes(match_u, spec_map, compiled, row_fb, out)
            + n_matched  # viol bytes read where a pair matched
        )
        # need per pair, counts per matched pair, compaction per row,
        # one need bit per (constraint, hot row)
        ops = (2 * viol.numel() + 4 * n_matched + 4 * viol.shape[1]
               + 6 * viol.shape[0] * r_cap)
    bytes_ms = b / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    if ops_ms > bytes_ms:
        return ops_ms, "operations", bytes_ms, ops_ms
    return bytes_ms, "bytes", bytes_ms, ops_ms


def _library_call(name, args):
    """One PyTorch call computing the same function, where one exists."""
    import torch

    if name == "slab_gather":
        tab, ids = args[0], args[1]
        ov = args[2] if len(args) > 2 else None
        if ov is None and int(ids.min()) >= 0 and int(ids.max()) < tab.shape[0]:
            flat = ids.reshape(-1).long()
            return lambda: torch.index_select(tab, 0, flat)
    return None


def _profiled(fn):
    """Run fn under the CUDA-activity profiler: -> (result, wall seconds,
    device-busy seconds or None when the profiler saw no device time,
    top kernels by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [
        (e.key, _device_time_us(e), e.count)
        for e in prof.key_averages()
    ]
    busy = sum(r[1] for r in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[:6]
    return out, wall, (busy if busy > 0 else None), [
        {"kernel": k[:60], "device_ms": us / 1e3, "count": n} for k, us, n in top
    ]


def phase_profile(client, drv):
    """Device-busy time against wall time for a second (warm-corpus)
    audit sweep and one more review batch, after the counted run."""
    _, wall_a, busy_a, top_a = _profiled(client.audit)
    audit_phases = dict(drv.stats["phase_seconds"])
    objs = review_batch(99, 256)
    _, wall_b, busy_b, top_b = _profiled(lambda: client.review_many(objs))
    print(json.dumps({
        "phase": "profile",
        "audit_warm": {"wall_s": wall_a, "device_busy_s": busy_a,
                       "phase_seconds": audit_phases, "top": top_a},
        "review_batch": {"wall_s": wall_b, "device_busy_s": busy_b,
                         "phase_seconds": drv.stats["phase_seconds"],
                         "top": top_b},
    }), flush=True)


def _match_battery(seed: int, u: int, n: int, width: int = 4,
                   cover: bool = True):
    """Seeded encoded match specs and review features over a tiny id
    space, so ids, selectors and labels collide often: -1 pads, wildcard
    kind rows, all five matchExpressions ops, namespaces, excluded
    namespaces, every scope code, namespaceSelector with the empty-labels
    candidate, and the object/oldObject 4-case (checked when `cover`).
    About half of each spec's parts are left unset so that matches stay
    common. -> (ms, fb) as numpy arrays."""
    import numpy as np

    r = np.random.default_rng(seed)

    def ids(shape, lo=-1, hi=4):
        return r.integers(lo, hi, size=shape).astype(np.int32)

    def flags(shape, p=0.5):
        return r.random(shape) < p

    def unset(a, p=0.5):
        a[r.random(a.shape[0]) < p] = -1  # blank whole spec rows
        return a

    def labels(rows):
        lab = ids((rows, width, 2), 0, 3)
        lab[r.random((rows, width)) < 0.4] = -1
        return lab

    def exprs():
        e = np.stack(
            [ids((u, 2), 0, 3), ids((u, 2), -1, 6), ids((u, 2), 0, 2)],
            axis=-1,
        )
        return unset(e, 0.6)

    kind = ids((u, 2, 2), -3, 2)
    kind[r.random((u, 2, 2)) < 0.4] = -2  # wildcard group/kind
    ms = {
        "kind_rows": kind,
        "ns_has": flags(u, 0.3), "ns_ids": ids((u, 3)),
        "excl_has": flags(u, 0.3), "excl_ids": ids((u, 3)),
        "scope": ids(u, 0, 5),
        "lab_invalid": flags(u, 0.05), "lab_ml": unset(ids((u, 2, 2), 0, 3)),
        "lab_expr": exprs(), "lab_expr_vals": ids((u, 2, 3)),
        "nssel_has": flags(u, 0.3), "nssel_matches_empty": flags(u),
        "nssel_invalid": flags(u, 0.05),
        "nssel_ml": unset(ids((u, 2, 2), 0, 3)),
        "nssel_expr": exprs(), "nssel_expr_vals": ids((u, 2, 3)),
    }
    fb = {
        "group_id": ids(n, -1, 2), "kind_id": ids(n, -1, 2),
        "kind_defined": flags(n, 0.8), "is_ns": flags(n, 0.3),
        "has_namespace": flags(n), "ns_name_id": ids(n),
        "obj_present": flags(n, 0.7), "old_present": flags(n, 0.5),
        "obj_labels": labels(n), "old_labels": labels(n),
        "nssel_defined": flags(n, 0.7), "nssel_labels": labels(n),
        "nssel_empty": flags(n, 0.3),
    }
    ops = set(ms["lab_expr"][..., 1].ravel()) | set(
        ms["nssel_expr"][..., 1].ravel()
    )
    if not cover:
        return ms, fb
    if not {1, 2, 3, 4, 5} <= ops:
        raise AssertionError(f"match battery {seed} misses an op: {ops}")
    if len(set(zip(fb["obj_present"], fb["old_present"]))) != 4:
        raise AssertionError(f"match battery {seed} misses a 4-case")
    return ms, fb


def _random_variants(device, seed: int = 7):
    """Seeded random inputs for kernel code paths the in-repo policy does
    not reach on the main path (K1's namespace, excluded-namespace,
    scope, namespaceSelector and labelSelector clauses over many spec
    rows; EGroup max/sum, int32/float32 values, g1/g01 axes; overlay
    slabs of every type; a hot-row window smaller than the hot rows):
    -> [(name, args, kwargs)]."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = []
    # the last, one spec row over few reviews, is an edge case only
    for bseed, u, n, width in ((0, 48, 4096, 4), (1, 48, 32768, 4),
                               (2, 24, 20000, 16), (3, 1, 1000, 4)):
        ms, fb = _match_battery(seed * 100 + bseed, u, n, width, u > 1)
        out.append(("match_matrix",
                    ({k: t(v) for k, v in ms.items()},
                     {k: t(v) for k, v in fb.items()}), {}))
    n, l, g0, g1 = 4096, 96, 16, 8
    idx0 = t(r.integers(-1, g0 + 2, (n, l)).astype(np.int32))
    idx1 = t(r.integers(-1, g1 + 2, (n, l)).astype(np.int32))
    mask = t(r.random((n, l)) < 0.6)
    vals = {
        "bool": t(r.random((n, l)) < 0.5),
        "int32": t(r.integers(-3, 900, (n, l)).astype(np.int32)),
        "float32": t(r.integers(-3, 900, (n, l)).astype(np.float32)),
    }
    for how in ("any", "sum", "max"):
        for vname, val in vals.items():
            for axis in ("g0", "g1", "g01"):
                init = -(10.0**30) if vname == "float32" and how == "max" else -1
                out.append(("egroup", (idx0, idx1, mask, val, axis, g0, g1,
                                       how, init), {}))
    v, cols, b = 5000, 24, 300
    ids = t(r.integers(0, v + b + 10, (2048, 64)).astype(np.int32))
    for dt in (np.bool_, np.int32, np.float32):
        tab = r.random((v, cols)) < 0.5 if dt == np.bool_ else r.integers(
            -9, 99, (v, cols)).astype(dt)
        ov = r.random((b, cols)) < 0.5 if dt == np.bool_ else r.integers(
            -9, 99, (b, cols)).astype(dt)
        out.append(("slab_gather", (t(tab), ids, None, 0), {}))
        out.append(("slab_gather", (t(tab), ids, t(ov), v - 40), {}))
    c, n2, u = 300, 20000, 7
    match_u = r.random((u, n2)) < 0.7
    spec_map = r.integers(1, u, c).astype(np.int32)
    spec_map[5] = 0  # one interpreter-only constraint ...
    match_u[0] = r.random(n2) < 0.01  # ... whose spec matches few rows
    compiled = np.arange(c) != 5
    match_u, spec_map, compiled = t(match_u), t(spec_map), t(compiled)
    viol = t(r.random((c, n2)) < 0.002)
    row_fb = t(r.random(n2) < 0.001)
    for r_cap in (64, 1024, 8192):
        out.append(("need_tail", (match_u, spec_map, viol, compiled, row_fb,
                                  n2 - 77, r_cap), {}))
    return out


def phase_variants():
    """Each kernel against its plain version on the random variants."""
    import torch
    from gatekeeper_tpu_torch.kernels import ops

    plain = {
        "match_matrix": ops.match_matrix_plain,
        "egroup": ops.egroup_plain,
        "slab_gather": ops.slab_gather_plain,
        "need_tail": ops.need_tail_plain,
    }
    checked = {}
    match_rate = []
    for i, (name, args, kw) in enumerate(_random_variants("cuda")):
        got = getattr(ops, name)(*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"variants: {name} #{i} differs")
        if name == "match_matrix":
            match_rate.append(float(want.float().mean()))
        checked[name] = checked.get(name, 0) + 1
    # the battery is only a check if both answers are common
    if not all(0.02 < m < 0.98 for m in match_rate[:3]):
        raise AssertionError(f"variants: match rates {match_rate}")
    print(json.dumps({"phase": "variants", "checked": checked,
                      "match_rates": match_rate}), flush=True)


def phase_kernels(rec, launches):
    import torch
    from gatekeeper_tpu_torch.kernels import ops

    plain = {
        "match_matrix": ops.match_matrix_plain,
        "slab_gather": ops.slab_gather_plain,
        "egroup": ops.egroup_plain,
        "need_tail": ops.need_tail_plain,
    }
    rows = []
    for name, (src, replaces) in KERNELS.items():
        calls = rec.calls[name]
        if not calls:
            raise AssertionError(f"kernels: no recorded input for {name}")
        worst = 0.0
        entry = None
        for key, (args, kw) in calls.items():
            kern = getattr(ops, name)
            out_k = kern(*args, **kw)
            out_p = plain[name](*args, **kw)
            torch.cuda.synchronize()
            if out_k.shape != out_p.shape or out_k.dtype != out_p.dtype:
                raise AssertionError(
                    f"kernels: {name}{key} shape/dtype {out_k.shape} "
                    f"{out_k.dtype} vs {out_p.shape} {out_p.dtype}"
                )
            err = (out_k.double() - out_p.double()).abs().max().item() if out_k.numel() else 0.0
            if err != 0.0:
                raise AssertionError(f"kernels: {name}{key} differs by {err}")
            worst = max(worst, err)
            # time the variant with the largest output (the main cost)
            if entry is None or out_k.numel() > entry[2].numel():
                entry = (args, kw, out_k, key)
        args, kw, out_k, key = entry
        kern = getattr(ops, name)

        def call_kernel():
            return kern(*args, **kw)

        def call_plain():
            return plain[name](*args, **kw)

        lib = _library_call(name, args)
        bound_ms, bound_by, bytes_ms, ops_ms = _bound(name, args, out_k)
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst,
            # device time of the kernel's own launches, and the wall time
            # per wrapper call (host issue included)
            "ms": _device_ms(call_kernel, KERNEL_FUNCS[name]),
            "host_ms": _time_ms(call_kernel),
            # every device op of one plain / library call
            "plain_ms": _device_ms(call_plain, reps=3),
            "plain_wall_ms": _time_ms(call_plain, reps=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "library_ms": _device_ms(lib) if lib is not None else None,
            "library_wall_ms": _time_ms(lib) if lib is not None else None,
            "timed_shape": [list(out_k.shape), str(out_k.dtype), str(key)],
            "variants_checked": len(calls),
        })
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "gatekeeper_tpu_torch")):
        print("chip_smoke: gatekeeper_tpu_torch not found beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    phase_card()
    phase_build()
    phase_parity("cuda")
    rec, launches, client, drv = phase_full("cuda")
    rows = phase_kernels(rec, launches)
    phase_variants()
    phase_profile(client, drv)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
