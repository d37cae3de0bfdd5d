# Copied from gatekeeper_tpu/compile/store.py; only these edits differ.
# Edit: the artifacts are the port's compiled libraries, not XLA cache
# entries: the CUDA kernel libraries nvcc builds for sm_90a
# (kernels/build.py, libgk_<name>_<srchash>.so) and the host libraries gcc
# and g++ build (native/: the C flattener and the bridge front). The
# per-fingerprint directory is `by-fingerprint/<fp12>/lib` (`lib_dir`, the
# reference's `xla_cache_dir`), the only directory those libraries are
# loaded from when a store is on; `lookup()` hands out a file there only
# while it hashes to its attestation, so no rejected, unattested or
# half-written file is loaded.
# Edit: machine_fingerprint() probes torch, not jaxlib and jax: platform
# and CPU flags as in the reference, torch's version and CUDA runtime, the
# device's name and compute capability, and the nvcc release (read from
# the toolkit's version.json or cuda.h; no compiler is started).
# Edit: payloads are copied in through a temporary file and os.replace,
# in adopt() as in attest(), so a second process sharing the root never
# reads a half-written file; adopt() replaces a lib_dir file whose content
# differs from the artifact it adopts, and an artifact adopted earlier and
# rejected now is revoked: its lib_dir file is removed and `revocations`
# counts it (kernels/build.py refuses a library loaded from it).
# Edit: adopt() leaves the integrity plane's golden sidecars
# (canary-*.json) and dot-prefixed temporary files in artifacts/ alone;
# the reference counts them as unattested payloads.
# Edit: the default root is build/gatekeeper_tpu_torch/store/ at the
# repository root, not ~/.cache/gatekeeper_tpu/xla.
"""Content-addressed artifact store with fingerprint-gated load.

Layout under the store root::

    <root>/
      artifacts/
        <sha256>.bin         # content-addressed library payload
        <sha256>.meta.json   # attestation: schema, fingerprint, sha256,
                             # the library's file name, created
      by-fingerprint/
        <fp12>/lib/          # the ONLY dir libraries are loaded from;
                             # populated by `adopt()` from artifacts
                             # whose attested fingerprint matches THIS
                             # machine, plus this machine's own builds

`adopt()` is the gate: it walks `artifacts/`, verifies each payload's
sha256 against its attestation, and materializes only fingerprint-
matching artifacts into this machine's private lib dir. Everything else
is rejected-and-counted (`program_store_rejected_total{reason}` with
reason ∈ fingerprint_mismatch | corrupt | schema | unattested) and never
loaded. Files sitting at the store root (an older flat layout) count as
`unattested`.

`attest()` is the reverse edge: after a build lands new libraries in the
lib dir, each is copied into `artifacts/` under its content hash with a
fingerprint attestation, making it loadable by identical machines and
rejectable by everyone else.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import platform
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

_log = logging.getLogger("gatekeeper_tpu_torch.compile")

SCHEMA_VERSION = 1

_META_SUFFIX = ".meta.json"
_PAYLOAD_SUFFIX = ".bin"
_SIDECAR_PREFIX = "canary-"  # integrity/plane.py's golden sidecars

DEFAULT_ROOT = (
    Path(__file__).resolve().parents[2] / "build" / "gatekeeper_tpu_torch"
    / "store"
)

# reasons are a closed set so the metric label can't explode
REJECT_REASONS = ("fingerprint_mismatch", "corrupt", "schema", "unattested")


def _cpu_flags_digest() -> str:
    """Stable digest of the CPU feature set (the ISA surface a host
    library may depend on). /proc/cpuinfo `flags` on x86, `Features`
    on arm64; falls back to the machine string off-Linux."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                low = line.lower()
                if low.startswith("flags") or low.startswith("features"):
                    flags = " ".join(
                        sorted(set(line.split(":", 1)[1].split()))
                    )
                    break
    except OSError:
        pass
    if not flags:
        flags = platform.processor() or platform.machine() or "unknown"
    return hashlib.sha256(flags.encode()).hexdigest()[:16]


def _nvcc_release() -> str:
    """The release of the nvcc this process would build with, read from
    its toolkit (version.json's cuda_nvcc entry, else cuda.h's
    CUDA_VERSION) without starting it; "none" without an nvcc."""
    from ..kernels.build import nvcc_path

    found = nvcc_path()
    if found is None:
        return "none"
    toolkit = Path(found).resolve().parents[1]
    try:
        with open(toolkit / "version.json") as f:
            return str(json.load(f)["cuda_nvcc"]["version"])
    except (OSError, ValueError, KeyError, TypeError):
        pass
    for header in (toolkit / "include" / "cuda.h",
                   *toolkit.glob("targets/*/include/cuda.h")):
        try:
            with open(header) as f:
                for line in f:
                    if line.startswith("#define CUDA_VERSION "):
                        v = int(line.split()[2])
                        return f"{v // 1000}.{v % 1000 // 10}"
        except (OSError, ValueError, IndexError):
            continue
    return "present"


def machine_fingerprint(probe_device: bool = True) -> Dict[str, str]:
    """Identity of the artifact-consuming machine: platform + CPU
    feature set + torch and its CUDA runtime + the device's name and
    compute capability + the nvcc release, plus the sha256 `digest`
    over all components. `probe_device=False` skips the CUDA device
    probe for device-free tests."""
    import torch

    comp: Dict[str, str] = {
        "platform": f"{platform.system()}-{platform.machine()}",
        "cpu_flags": _cpu_flags_digest(),
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda or "none"),
        "device_name": "none",
        "capability": "none",
        "nvcc": _nvcc_release(),
    }
    if probe_device and torch.cuda.is_available():
        comp["device_name"] = torch.cuda.get_device_name(0)
        major, minor = torch.cuda.get_device_capability(0)
        comp["capability"] = f"{major}.{minor}"
    comp["digest"] = hashlib.sha256(
        json.dumps(
            {k: v for k, v in comp.items() if k != "digest"},
            sort_keys=True,
        ).encode()
    ).hexdigest()
    return comp


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _stat_key(path: str) -> tuple:
    st = os.stat(path)
    return (st.st_size, st.st_mtime_ns)


def _copy_in(src: str, dst: str) -> None:
    """Copy `src` to `dst` through a temporary file in dst's directory:
    a reader never sees a partial `dst`."""
    tmp = os.path.join(
        os.path.dirname(dst),
        f".{os.path.basename(dst)}.{os.getpid()}.{threading.get_ident()}.tmp",
    )
    try:
        shutil.copy(src, tmp)  # content and mode (the bridge front runs)
        os.replace(tmp, dst)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _skipped(name: str) -> bool:
    """Files of artifacts/ that are not artifacts: temporaries and the
    integrity plane's golden sidecars."""
    return name.startswith(".") or name.startswith(_SIDECAR_PREFIX)


class ProgramStore:
    """Fingerprint-gated store of the compiled libraries.

    Thread-safe; one instance per process (kernels/build.py holds it).
    The `fingerprint` parameter accepts a full component dict or a bare
    digest string — the latter is the device-free test override."""

    def __init__(
        self,
        root: str,
        metrics: Optional[Any] = None,
        fingerprint: Optional[Union[Dict[str, str], str]] = None,
        replica: Optional[str] = None,
        adopt: bool = True,
        probe_device: bool = True,
    ):
        self.root = os.path.abspath(os.path.expanduser(str(root)))
        self.metrics = metrics
        self.replica = replica
        fp = fingerprint
        if fp is None:
            fp = machine_fingerprint(probe_device=probe_device)
        if isinstance(fp, str):
            fp = {"digest": fp}
        self.fingerprint: Dict[str, str] = dict(fp)
        self.fp_digest: str = self.fingerprint["digest"]
        self.artifacts_dir = os.path.join(self.root, "artifacts")
        self.lib_dir = os.path.join(
            self.root, "by-fingerprint", self.fp_digest[:12], "lib"
        )
        os.makedirs(self.artifacts_dir, exist_ok=True)
        os.makedirs(self.lib_dir, exist_ok=True)
        self._lock = threading.Lock()
        # library filename -> sha256, for entries of THIS fingerprint
        # adopted or attested (so attest() is incremental)
        self._attested: Dict[str, str] = {}
        # library filename -> (size, mtime) of the lib-dir file last
        # hashed, so attest() re-hashes only a file rebuilt since
        self._stat: Dict[str, tuple] = {}
        self.hits = 0
        self.misses = 0
        self.saves = 0
        self.rejected: Dict[str, int] = {r: 0 for r in REJECT_REASONS}
        # adopted libraries whose artifact a later adopt() rejected
        self.revocations = 0
        # last adopt() verdict per artifact, for /debug/programs and the
        # compile_storm flight record
        self._rows: List[Dict[str, Any]] = []
        if adopt:
            self.adopt()

    # ------------------------------------------------------------------
    # counters (one literal call site per metric)

    def _note_hit(self) -> None:
        self.hits += 1
        if self.metrics is not None:
            self.metrics.record("program_store_hits_total", 1)

    def note_miss(self) -> None:
        """Called when a program or library had to be compiled (no
        adoptable artifact covered it)."""
        with self._lock:
            self.misses += 1
        if self.metrics is not None:
            self.metrics.record("program_store_misses_total", 1)

    def _note_save(self) -> None:
        self.saves += 1
        if self.metrics is not None:
            self.metrics.record("program_store_saves_total", 1)

    def _note_reject(self, reason: str) -> None:
        self.rejected[reason] = self.rejected.get(reason, 0) + 1
        if self.metrics is not None:
            self.metrics.record(
                "program_store_rejected_total", 1, reason=reason
            )

    def _note_entries(self, n: int) -> None:
        if self.metrics is not None:
            self.metrics.gauge("program_store_entries", n)

    # ------------------------------------------------------------------

    def adopt(self) -> Dict[str, int]:
        """Validate every stored artifact and materialize the ones
        attested for THIS machine into the private lib dir. Returns
        {adopted, rejected} counts for this pass. Never raises: a broken
        artifact is a rejection, not an exception."""
        adopted = 0
        rejected = 0
        rows: List[Dict[str, Any]] = []
        with self._lock:
            try:
                names = sorted(
                    n for n in os.listdir(self.artifacts_dir)
                    if not _skipped(n)
                )
            except OSError:
                names = []
            metas = [n for n in names if n.endswith(_META_SUFFIX)]
            claimed = set()
            for meta_name in metas:
                meta_path = os.path.join(self.artifacts_dir, meta_name)
                sha_from_name = meta_name[: -len(_META_SUFFIX)]
                row: Dict[str, Any] = {
                    "artifact": sha_from_name[:12],
                    "status": "",
                    "reason": "",
                }
                verdict = self._validate_locked(
                    meta_path, sha_from_name, row
                )
                claimed.add(sha_from_name + _PAYLOAD_SUFFIX)
                if verdict is None:
                    rejected += 1
                    self._revoke_locked(sha_from_name)
                else:
                    filename, payload = verdict
                    dst = os.path.join(self.lib_dir, filename)
                    try:
                        if (
                            not os.path.exists(dst)
                            or _sha256_file(dst) != sha_from_name
                        ):
                            _copy_in(payload, dst)
                        self._attested[filename] = sha_from_name
                        self._stat[filename] = _stat_key(dst)
                        adopted += 1
                        row["status"] = "adopted"
                        self._note_hit()
                    except OSError as e:
                        rejected += 1
                        row["status"] = "rejected"
                        row["reason"] = "corrupt"
                        row["error"] = str(e)
                        self._note_reject("corrupt")
                rows.append(row)
            # payloads with no attestation are never loaded
            for n in names:
                if n.endswith(_META_SUFFIX) or n in claimed:
                    continue
                rejected += 1
                rows.append({
                    "artifact": n[:12],
                    "status": "rejected",
                    "reason": "unattested",
                })
                self._note_reject("unattested")
            # files at the root (an older flat layout): binaries of
            # unknown origin — reject, do not load, do not delete (an
            # operator may want them back)
            try:
                for n in sorted(os.listdir(self.root)):
                    p = os.path.join(self.root, n)
                    if os.path.isdir(p):
                        continue
                    rejected += 1
                    rows.append({
                        "artifact": n[:24],
                        "status": "rejected",
                        "reason": "unattested",
                        "legacy": True,
                    })
                    self._note_reject("unattested")
            except OSError:
                pass
            self._rows = rows
            self._note_entries(len(self._attested))
        return {"adopted": adopted, "rejected": rejected}

    def _revoke_locked(self, sha: str) -> None:
        """An artifact adopted or attested earlier is rejected now: its
        library leaves the lib dir and is never handed out again."""
        for filename, got in list(self._attested.items()):
            if got != sha:
                continue
            del self._attested[filename]
            self.revocations += 1
            try:
                os.unlink(os.path.join(self.lib_dir, filename))
            except OSError:
                pass

    def _validate_locked(self, meta_path, sha_from_name, row):
        """One artifact through the gate. Returns (filename, payload
        path) when loadable on THIS machine, else None after counting
        the rejection and filling `row`."""
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            if not isinstance(meta, dict):
                raise ValueError("meta is not an object")
        except Exception:
            row["status"] = "rejected"
            row["reason"] = "corrupt"
            self._note_reject("corrupt")
            return None
        if meta.get("schema") != SCHEMA_VERSION:
            row["status"] = "rejected"
            row["reason"] = "schema"
            self._note_reject("schema")
            return None
        sha = meta.get("sha256")
        filename = meta.get("filename")
        fp = meta.get("fingerprint")
        if (
            not isinstance(sha, str)
            or not isinstance(filename, str)
            or not isinstance(fp, str)
            or sha != sha_from_name
            or os.path.basename(filename) != filename
        ):
            row["status"] = "rejected"
            row["reason"] = "schema"
            self._note_reject("schema")
            return None
        row["filename"] = filename
        row["fingerprint"] = fp[:12]
        payload = os.path.join(
            self.artifacts_dir, sha + _PAYLOAD_SUFFIX
        )
        try:
            actual = _sha256_file(payload)
        except OSError:
            actual = ""
        if actual != sha:
            row["status"] = "rejected"
            row["reason"] = "corrupt"
            self._note_reject("corrupt")
            return None
        # the fingerprint gate proper: content is intact but was
        # built by a different machine class — never load it
        if fp != self.fp_digest:
            row["status"] = "rejected"
            row["reason"] = "fingerprint_mismatch"
            self._note_reject("fingerprint_mismatch")
            return None
        return filename, payload

    def attest(self) -> int:
        """Content-address any new libraries this machine has built in
        the lib dir and write their attestation. Returns the number of
        newly attested artifacts."""
        new = 0
        with self._lock:
            try:
                names = sorted(os.listdir(self.lib_dir))
            except OSError:
                return 0
            for filename in names:
                src = os.path.join(self.lib_dir, filename)
                if filename.startswith(".") or not os.path.isfile(src):
                    continue
                try:
                    key = _stat_key(src)
                    if (
                        filename in self._attested
                        and self._stat.get(filename) == key
                    ):
                        continue
                    sha = _sha256_file(src)
                    self._stat[filename] = key
                    if self._attested.get(filename) == sha:
                        continue
                    payload = os.path.join(
                        self.artifacts_dir, sha + _PAYLOAD_SUFFIX
                    )
                    if not os.path.exists(payload):
                        _copy_in(src, payload)
                    meta = {
                        "schema": SCHEMA_VERSION,
                        "sha256": sha,
                        "filename": filename,
                        "fingerprint": self.fp_digest,
                        "torch": self.fingerprint.get("torch", "none"),
                        "nvcc": self.fingerprint.get("nvcc", "none"),
                        "created": time.time(),
                    }
                    tmp = os.path.join(
                        self.artifacts_dir,
                        f".{sha}{_META_SUFFIX}.{os.getpid()}.tmp",
                    )
                    with open(tmp, "w") as f:
                        json.dump(meta, f, sort_keys=True)
                    os.replace(
                        tmp,
                        os.path.join(
                            self.artifacts_dir, sha + _META_SUFFIX
                        ),
                    )
                except OSError as e:
                    _log.warning(
                        "program store: attest failed for %s: %s",
                        filename, e,
                    )
                    continue
                self._attested[filename] = sha
                new += 1
                self._note_save()
            self._note_entries(len(self._attested))
        return new

    def lookup(self, filename: str) -> Optional[str]:
        """The lib-dir path of `filename` when it is adopted or attested
        for this machine and its content still hashes to that
        attestation; None otherwise (the caller builds it)."""
        with self._lock:
            sha = self._attested.get(filename)
        if sha is None:
            return None
        path = os.path.join(self.lib_dir, filename)
        try:
            if _sha256_file(path) == sha:
                return path
        except OSError:
            pass
        return None

    # ------------------------------------------------------------------
    # introspection (for /debug/programs and the flight recorder)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "root": self.root,
                "lib_dir": self.lib_dir,
                "fingerprint": self.fp_digest,
                "fingerprint_components": {
                    k: v
                    for k, v in self.fingerprint.items()
                    if k != "digest"
                },
                "entries": len(self._attested),
                "hits": self.hits,
                "misses": self.misses,
                "saves": self.saves,
                "rejected": dict(self.rejected),
                "revocations": self.revocations,
            }

    def table(self) -> List[Dict[str, Any]]:
        """Per-artifact adoption verdicts from the last adopt() pass."""
        with self._lock:
            return [dict(r) for r in self._rows]


def store_from_env(
    metrics: Optional[Any] = None,
    replica: Optional[str] = None,
) -> Optional[ProgramStore]:
    """Build the process store from the environment, honoring the kill
    switch (GATEKEEPER_TPU_NO_COMPILE_CACHE=1 -> None, which
    tests/conftest.py sets so the tests never touch the store).
    GATEKEEPER_TPU_COMPILE_CACHE_DIR moves the root (a volume shared by
    a node pool)."""
    if os.environ.get("GATEKEEPER_TPU_NO_COMPILE_CACHE") == "1":
        return None
    root = os.environ.get("GATEKEEPER_TPU_COMPILE_CACHE_DIR") or str(
        DEFAULT_ROOT
    )
    try:
        return ProgramStore(root, metrics=metrics, replica=replica)
    except OSError as e:
        _log.warning("program store unavailable at %s: %s", root, e)
        return None
