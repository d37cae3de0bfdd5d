"""The port's compile-artifact store (gatekeeper_tpu_torch/compile/) and
the loaders it gates (kernels/build.py, native/), against the JAX
package's ProgramStore on the same seeded artifact directories.

No nvcc runs here: the kernel builder's compiler and dlopen are stubbed
where a test needs them, and the native host libraries build with gcc.
"""

import hashlib
import json
import os
import shutil
import subprocess

import pytest

from gatekeeper_tpu.compile import ProgramStore as JProgramStore
from gatekeeper_tpu_torch.compile import (
    REJECT_REASONS,
    SCHEMA_VERSION,
    ProgramStore,
    machine_fingerprint,
    store_from_env,
)
from gatekeeper_tpu_torch.compile import store as store_mod
from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.torchdriver import (
    TorchDriver,
    constraint_key,
)
from gatekeeper_tpu_torch.kernels import build
from gatekeeper_tpu_torch.metrics import MetricsRegistry

TARGET = "admission.k8s.gatekeeper.sh"

REQ_LABELS = """package storereqlabels
violation[{"msg": msg}] {
    required := {key | key := input.parameters.labels[_]}
    provided := {key | input.review.object.metadata.labels[key]}
    missing := required - provided
    count(missing) > 0
    msg := sprintf("missing: %v", [missing])
}
"""


def _write_artifact(root, payload, fingerprint, schema=SCHEMA_VERSION,
                    filename="libgk_x.so", tamper=False, meta=True):
    art = os.path.join(root, "artifacts")
    os.makedirs(art, exist_ok=True)
    sha = hashlib.sha256(payload).hexdigest()
    with open(os.path.join(art, f"{sha}.bin"), "wb") as f:
        f.write(payload + (b"-tampered" if tamper else b""))
    if meta:
        with open(os.path.join(art, f"{sha}.meta.json"), "w") as f:
            json.dump({
                "schema": schema,
                "sha256": sha,
                "filename": filename,
                "fingerprint": fingerprint,
                "created": 0,
            }, f)
    return sha


def _seed_mixed(root):
    """One valid artifact and one per reject reason (two unattested: an
    orphan payload and a legacy file at the root)."""
    _write_artifact(root, b"good-artifact", "fp-me", filename="prog-good")
    _write_artifact(root, b"foreign-artifact", "fp-other",
                    filename="prog-foreign")
    _write_artifact(root, b"tampered-artifact", "fp-me", tamper=True,
                    filename="prog-tampered")
    _write_artifact(root, b"future-artifact", "fp-me",
                    schema=SCHEMA_VERSION + 1, filename="prog-future")
    _write_artifact(root, b"orphan-payload", "fp-me", meta=False)
    with open(os.path.join(root, "legacy_flat_entry"), "wb") as f:
        f.write(b"legacy-blob")


def _seed_schema_zero(root):
    _write_artifact(root, b"old-schema", "fp-me", schema=0,
                    filename="prog-old")
    _write_artifact(root, b"good-2", "fp-me", filename="prog-2")


def _seed_bad_meta(root):
    art = os.path.join(root, "artifacts")
    os.makedirs(art, exist_ok=True)
    with open(os.path.join(art, "ab" * 32 + ".meta.json"), "w") as f:
        f.write("{not json")
    _write_artifact(root, b"renamed", "fp-me", filename="../escape")


def _seed_empty(root):
    os.makedirs(root, exist_ok=True)


SEEDS = {
    "mixed": _seed_mixed,
    "schema_zero": _seed_schema_zero,
    "bad_meta": _seed_bad_meta,
    "empty": _seed_empty,
}


def test_fingerprint_gate_rejects_counts_and_never_loads(tmp_path):
    """adopt() materializes ONLY the valid artifact into the lib dir and
    counts every rejection under its closed-set reason label."""
    root = str(tmp_path / "store")
    os.makedirs(root)
    _seed_mixed(root)
    reg = MetricsRegistry()
    store = ProgramStore(root, metrics=reg, fingerprint="fp-me")
    assert store.rejected == {
        "fingerprint_mismatch": 1, "corrupt": 1, "schema": 1,
        "unattested": 2,
    }
    assert tuple(store.rejected) == REJECT_REASONS
    assert store.hits == 1
    assert os.listdir(store.lib_dir) == ["prog-good"]
    with open(os.path.join(store.lib_dir, "prog-good"), "rb") as f:
        assert f.read() == b"good-artifact"
    # lookup hands out only what was adopted
    assert store.lookup("prog-good") == os.path.join(store.lib_dir,
                                                     "prog-good")
    for name in ("prog-foreign", "prog-tampered", "prog-future"):
        assert store.lookup(name) is None
    counters = reg.snapshot()["counters"]
    for reason, n in store.rejected.items():
        key = f'program_store_rejected_total{{reason="{reason}"}}'
        assert counters.get(key) == n
    assert counters.get("program_store_hits_total") == 1
    assert {r["reason"] for r in store.table()
            if r["status"] == "rejected"} == set(REJECT_REASONS)


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_adopt_counts_and_table_equal_jax(seed, tmp_path):
    """The same seeded directory and the same bare-digest fingerprint give
    equal adopt and reject counts and equal table() rows in both
    packages."""
    roots = {}
    for tag in ("jax", "torch"):
        roots[tag] = str(tmp_path / tag)
        os.makedirs(roots[tag])
        SEEDS[seed](roots[tag])
    j = JProgramStore(roots["jax"], fingerprint="fp-me")
    t = ProgramStore(roots["torch"], fingerprint="fp-me")
    assert t.table() == j.table()
    assert (t.hits, t.misses, t.saves, t.rejected) == (
        j.hits, j.misses, j.saves, j.rejected)
    assert sorted(os.listdir(t.lib_dir)) == sorted(
        os.listdir(j.xla_cache_dir))
    assert t.adopt() == j.adopt()


def test_attest_roundtrip_same_fingerprint_adopts_foreign_rejects(tmp_path):
    """A library this machine built and attested is adopted by an
    identical fingerprint and rejected by a different one, as in the JAX
    package; attest() is incremental and re-attests a rebuilt file."""
    counts = {}
    for tag, cls, attr in (("jax", JProgramStore, "xla_cache_dir"),
                           ("torch", ProgramStore, "lib_dir")):
        root = str(tmp_path / tag)
        a = cls(root, fingerprint="fp-a")
        with open(os.path.join(getattr(a, attr), "prog-0"), "wb") as f:
            f.write(b"compiled-on-a")
        assert a.attest() == 1 and a.saves == 1
        assert a.attest() == 0
        a2 = cls(root, fingerprint="fp-a")
        b = cls(root, fingerprint="fp-b")
        assert os.listdir(getattr(b, attr)) == []
        counts[tag] = (a2.hits, a2.rejected, b.hits, b.rejected,
                       a2.table(), b.table())
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][2] == 0
    assert counts["torch"][3]["fingerprint_mismatch"] == 1
    # a rebuilt file (new content under the same name) is attested anew
    a = ProgramStore(str(tmp_path / "torch"), fingerprint="fp-a")
    path = os.path.join(a.lib_dir, "prog-0")
    os.unlink(path)
    with open(path, "wb") as f:
        f.write(b"compiled-again")
    assert a.attest() == 1
    assert a.lookup("prog-0") == path


def test_revoked_artifact_leaves_the_lib_dir(tmp_path):
    """An adopted artifact that a later adopt() rejects is removed from
    the lib dir, counted, and no longer handed out."""
    root = str(tmp_path / "store")
    sha = _write_artifact(root, b"good", "fp-me", filename="prog-good")
    store = ProgramStore(root, fingerprint="fp-me")
    assert store.lookup("prog-good") is not None
    with open(os.path.join(root, "artifacts", f"{sha}.bin"), "ab") as f:
        f.write(b"!")
    assert store.adopt() == {"adopted": 0, "rejected": 1}
    assert store.revocations == 1
    assert store.lookup("prog-good") is None
    assert os.listdir(store.lib_dir) == []


def test_golden_sidecars_and_temporaries_are_not_artifacts(tmp_path):
    """The integrity plane's golden sidecars and temporary files live in
    artifacts/; the port's adopt() leaves them alone where the JAX
    package counts them as unattested payloads."""
    from gatekeeper_tpu_torch.integrity import IntegrityPlane

    counts = {}
    for tag, cls in (("jax", JProgramStore), ("torch", ProgramStore)):
        root = str(tmp_path / tag)
        store = cls(root, fingerprint="fp-me")
        plane = IntegrityPlane(store=store)
        plane._sidecar_save(TARGET, "sig", {"reviews": [], "digests": []})
        assert plane._sidecar_load(TARGET, "sig") == {
            "reviews": [], "digests": []}
        with open(os.path.join(root, "artifacts", ".x.tmp"), "w") as f:
            f.write("partial")
        counts[tag] = cls(root, fingerprint="fp-me").rejected["unattested"]
    assert counts == {"jax": 2, "torch": 0}


def test_machine_fingerprint_and_store_from_env(tmp_path, monkeypatch):
    fp = machine_fingerprint(probe_device=False)
    assert fp["digest"] == machine_fingerprint(probe_device=False)["digest"]
    for k in ("platform", "cpu_flags", "torch", "cuda", "device_name",
              "capability", "nvcc"):
        assert k in fp
    assert fp["device_name"] == "none" and fp["capability"] == "none"
    # no nvcc on this host; the component says so without starting one
    if build.nvcc_path() is None:
        assert fp["nvcc"] == "none"
    assert store_mod.DEFAULT_ROOT.parts[-3:] == (
        "build", "gatekeeper_tpu_torch", "store")
    # the kill switch (tests/conftest.py sets it for every test)
    assert os.environ.get("GATEKEEPER_TPU_NO_COMPILE_CACHE") == "1"
    assert store_from_env() is None
    monkeypatch.delenv("GATEKEEPER_TPU_NO_COMPILE_CACHE")
    monkeypatch.setenv("GATEKEEPER_TPU_COMPILE_CACHE_DIR",
                       str(tmp_path / "envstore"))
    store = store_from_env()
    assert store is not None and store.root == str(tmp_path / "envstore")
    assert store.fp_digest == machine_fingerprint()["digest"]
    monkeypatch.delenv("GATEKEEPER_TPU_COMPILE_CACHE_DIR")
    monkeypatch.setattr(store_mod, "DEFAULT_ROOT", tmp_path / "default")
    assert store_from_env().root == str(tmp_path / "default")


def test_nvcc_release_is_read_from_the_toolkit(tmp_path, monkeypatch):
    """The nvcc component comes from the toolkit's version.json beside
    the compiler; no compiler process starts."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    (bin_dir / "nvcc").write_text("#!/bin/sh\nexit 1\n")
    (tmp_path / "cuda" / "version.json").write_text(json.dumps(
        {"cuda_nvcc": {"name": "CUDA NVCC", "version": "12.4.131"}}))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(bin_dir / "nvcc"))

    def no_process(*a, **k):
        raise AssertionError("the fingerprint started a process")

    monkeypatch.setattr(subprocess, "Popen", no_process)
    monkeypatch.setattr(subprocess, "run", no_process)
    assert machine_fingerprint(probe_device=False)["nvcc"] == "12.4.131"
    # a toolkit without version.json: cuda.h's CUDA_VERSION
    (tmp_path / "cuda" / "version.json").unlink()
    inc = tmp_path / "cuda" / "targets" / "x86_64-linux" / "include"
    inc.mkdir(parents=True)
    (inc / "cuda.h").write_text("#pragma once\n#define CUDA_VERSION 12080\n")
    assert machine_fingerprint(probe_device=False)["nvcc"] == "12.8"


class _FakeLib:
    def __init__(self, path):
        self.path = path
        for fn_name, _ in build._SIGNATURES.values():
            setattr(self, fn_name, type("Fn", (), {})())


class _FakeNvcc:
    """Stands in for subprocess.Popen of nvcc: writes the -o file."""

    calls = []

    def __init__(self, cmd, **kw):
        _FakeNvcc.calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"built:" + os.path.basename(cmd[-1]).encode())
        self.returncode = 0

    def communicate(self):
        return "ptxas info", None


@pytest.fixture
def kernel_store(tmp_path, monkeypatch):
    """kernels/build.py with a store at tmp_path/store, dlopen and nvcc
    stubbed; yields the store's root."""
    root = str(tmp_path / "store")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_store", [])
    monkeypatch.setattr(build.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(
        store_mod, "store_from_env",
        lambda metrics=None, replica=None: ProgramStore(
            root, fingerprint="fp-me"))
    monkeypatch.setattr("gatekeeper_tpu_torch.compile.store_from_env",
                        store_mod.store_from_env)
    _FakeNvcc.calls = []
    yield root


def test_library_loads_an_adopted_artifact_before_calling_nvcc(kernel_store):
    """library(name) finds the adopted libgk_<name>_<srchash>.so in the
    store's lib dir and loads it from there; nvcc never runs."""
    filename = build._filename("match")
    _write_artifact(kernel_store, b"adopted-match", "fp-me",
                    filename=filename)
    # a forged artifact for another library, attested for another machine
    _write_artifact(kernel_store, b"forged-slab", "fp-other",
                    filename=build._filename("slab"))
    lib = build.library("match")
    store = build.process_store()
    assert lib.path == os.path.join(store.lib_dir, filename)
    assert _FakeNvcc.calls == []
    assert build.library("match") is lib
    assert build._target("match") == build.Path(lib.path)
    # the forged artifact is rejected and never loaded: slab builds
    slab = build.library("slab")
    assert len(_FakeNvcc.calls) == 1
    with open(slab.path, "rb") as f:
        assert f.read() == b"built:slab.cu"
    assert store.rejected["fingerprint_mismatch"] == 1
    assert store.misses == 1 and store.saves == 1
    # what was built is attested: a second process adopts both
    again = ProgramStore(kernel_store, fingerprint="fp-me")
    assert again.hits == 2
    assert again.lookup(build._filename("slab")) is not None


def test_library_refuses_a_revoked_load(kernel_store):
    """A library loaded from an artifact the store later revokes is not
    launched again from its stale path."""
    filename = build._filename("group")
    sha = _write_artifact(kernel_store, b"adopted-group", "fp-me",
                          filename=filename)
    build.library("group")
    store = build.process_store()
    with open(os.path.join(kernel_store, "artifacts", f"{sha}.bin"),
              "ab") as f:
        f.write(b"corrupted later")
    store.adopt()
    assert store.revocations == 1
    with pytest.raises(RuntimeError, match="revoked"):
        build.library("group")


def test_build_all_compiles_only_what_the_store_lacks(kernel_store):
    have = build._filename("need")
    _write_artifact(kernel_store, b"adopted-need", "fp-me", filename=have)
    logs = build.build_all(("need", "delta", "gather"))
    assert sorted(logs) == ["delta", "gather"]
    assert sorted(os.path.basename(c[-1]) for c in _FakeNvcc.calls) == [
        "delta.cu", "gather.cu"]
    store = build.process_store()
    assert store.saves == 2
    for name in ("need", "delta", "gather"):
        assert store.lookup(build._filename(name)) is not None
    # nothing half-written is left where libraries are loaded from
    assert not [n for n in os.listdir(store.lib_dir) if n.startswith(".")]


def test_native_libraries_resolve_through_the_store(tmp_path, monkeypatch):
    """The C flattener and the bridge front build into the store's lib
    dir and are attested; a second process adopts them and compiles
    nothing."""
    from gatekeeper_tpu_torch import native

    root = str(tmp_path / "store")
    monkeypatch.setattr(build, "_store", [ProgramStore(root,
                                                       fingerprint="fp-me")])
    monkeypatch.setattr(native, "_mod", None)
    mod = native.load_flatten_native()
    exe = native.build_frontend()
    store = build.process_store()
    assert os.path.dirname(mod.__file__) == store.lib_dir
    assert str(exe.parent) == store.lib_dir and os.access(exe, os.X_OK)
    assert store.saves == 2 and store.misses == 2

    def no_compile(*a, **k):
        raise AssertionError("compiled what the store holds")

    monkeypatch.setattr(native, "_compile", no_compile)
    built = exe.read_bytes()
    shutil.rmtree(store.lib_dir)  # a fresh process: an empty load dir
    second = ProgramStore(root, fingerprint="fp-me")
    monkeypatch.setattr(build, "_store", [second])
    monkeypatch.setattr(native, "_mod", None)
    assert second.hits == 2
    assert native.load_flatten_native().encode_rows is not None
    exe2 = native.build_frontend()
    assert exe2.read_bytes() == built and os.access(exe2, os.X_OK)


def _client():
    drv = TorchDriver(device="cpu")
    client = Backend(drv).new_client(K8sValidationTarget())
    client.add_template({
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "storereqlabels"},
        "spec": {"crd": {"spec": {"names": {"kind": "StoreReqLabels"}}},
                 "targets": [{"target": TARGET, "rego": REQ_LABELS}]},
    })
    for i in range(2):
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "StoreReqLabels",
            "metadata": {"name": f"req-{i}"},
            "spec": {"parameters": {"labels": [f"l{i}"]}},
        })
    return drv, client


def test_subset_signature_hashes_the_store_fingerprint(tmp_path):
    """_subset_signature covers the store's fingerprint: the same subset
    signs differently under another machine's store, as in the JAX
    driver; compile_plane_stats carries the store's stats."""
    drv, _ = _client()
    assert drv.program_store is None  # a CPU driver has none
    subset = frozenset(constraint_key(c) for c in drv._constraints(TARGET))
    sigs = {}
    for fp in (None, "a" * 64, "b" * 64):
        drv.program_store = (
            None if fp is None
            else ProgramStore(str(tmp_path / str(fp)[:4]), fingerprint=fp)
        )
        drv._sig_cache.clear()
        sigs[fp] = drv.subset_signature(TARGET, subset)
    assert len(set(sigs.values())) == 3
    stats = drv.compile_plane_stats()
    assert stats["store"]["fingerprint"] == "b" * 64
    assert stats["store"]["rejected"] == {r: 0 for r in REJECT_REASONS}


def test_programs_table_carries_the_store_table(tmp_path):
    """/debug/programs (the partition plane's programs_table, also the
    flight recorder's `programs` source) carries the store's adoption
    table and stats when the driver has a store, as in the JAX
    package."""
    from gatekeeper_tpu_torch.parallel.partition import PartitionDispatcher

    drv, client = _client()
    root = str(tmp_path / "s")
    os.makedirs(root)
    _seed_mixed(root)
    drv.program_store = ProgramStore(root, fingerprint="fp-me")
    disp = PartitionDispatcher(client, TARGET, k=2)
    try:
        doc = disp.programs_table()
        assert doc["store_table"] == drv.program_store.table()
        assert len(doc["store_table"]) == 6
        assert doc["compile_plane"]["store"]["rejected"] == {
            "fingerprint_mismatch": 1, "corrupt": 1, "schema": 1,
            "unattested": 2}
        drv.program_store = None
        assert "store_table" not in disp.programs_table()
    finally:
        disp.close()


def test_warm_and_subset_swap_attest_the_lib_dir(tmp_path):
    """The driver attests what landed in the lib dir after a warm and
    after a subset swap, where the JAX driver attests."""
    drv, client = _client()
    store = drv.program_store = ProgramStore(str(tmp_path / "s"),
                                             fingerprint="fp-me")
    for name in ("after-warm", "after-swap"):
        with open(os.path.join(store.lib_dir, name), "wb") as f:
            f.write(name.encode())
        if name == "after-warm":
            assert drv.warm_review_path(TARGET, [])
        else:
            subset = frozenset(
                constraint_key(c) for c in drv._constraints(TARGET)[:1])
            assert client.prepare_subset(subset) is True
        assert store.lookup(name) is not None, name
    assert store.saves == 2
    assert store.misses == drv.program_compiles > 0
