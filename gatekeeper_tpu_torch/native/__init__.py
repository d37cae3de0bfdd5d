# Copied from gatekeeper_tpu/native/__init__.py (:43-99); only these edits differ.
# Edit: the shared object is built into build/gatekeeper_tpu_torch/native/
# (beside the CUDA kernels, kernels/build.py's BUILD_DIR) instead of
# ~/.cache; a failed build or load raises with the compiler's output instead
# of returning None; the GATEKEEPER_TPU_NO_NATIVE switch and
# last_build_error are left out (the Python encoder runs only when the
# caller asks for it: encode_token_table(native=False),
# TorchDriver(encoder="python")).
# Edit: build_frontend (the JAX package's gatekeeper_tpu/webhook/bridge.py
# :32-64) lives here and builds bridge_frontend.cpp the same way, with g++
# (or $CXX), into the same directory.
# Edit: with the compile-artifact store on (kernels/build.py's
# process_store), load_flatten_native() and build_frontend() load from the
# store's per-fingerprint lib dir, building there and attesting only what
# the store does not hold for this machine (kernels/build.py resolve).
"""Native host-side components of the port.

`flatten.c` is the C token flattener: a CPython extension that walks the
parsed objects and interns straight into the caller's Vocab, the
counterpart of the Python `flatten_leaves` + `encode_token_table`. It is
host code, not a device kernel. It is compiled with gcc (or $CC) on first
use into a shared object whose name carries a hash of the source, so an
edited source rebuilds; nothing is built when this module is imported.

`bridge_frontend.cpp` is the native HTTP front of the admission webhook
(webhook/bridge.py runs it as a child process); `build_frontend` compiles
it with g++ (or $CXX) into the same directory, under a name that carries
a hash of the source. With the compile-artifact store on, both live in
the store's lib dir instead (kernels/build.py `resolve`).
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Optional

from ..kernels.build import BUILD_DIR, resolve

SOURCE = Path(__file__).resolve().parent / "flatten.c"
FRONTEND_SOURCE = Path(__file__).resolve().parent / "bridge_frontend.cpp"
NATIVE_DIR = BUILD_DIR / "native"

_lock = threading.Lock()
_mod = None


def load_flatten_native():
    """-> the _flatten_native module, building it first if needed. Raises
    RuntimeError, with the compiler's output, when the build fails."""
    global _mod
    if _mod is None:
        with _lock:
            if _mod is None:
                _mod = _load(resolve(
                    _flatten_name(), _compile_flatten, NATIVE_DIR
                ))
    return _mod


def load_or_build(out_dir: Path):
    """Build flatten.c into `out_dir` unless its artifact is there, then
    load it."""
    so = Path(out_dir) / _flatten_name()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        _compile_flatten(so)
    return _load(so)


def _flatten_name() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return _artifact_name(SOURCE, "_flatten_native", suffix)


def _compile_flatten(so: Path) -> None:
    cc = os.environ.get("CC", "gcc")
    include = sysconfig.get_paths()["include"]
    cmd = [cc, "-O2", "-shared", "-fPIC", f"-I{include}", str(SOURCE)]
    if sys.platform == "darwin":
        # clang needs the Python symbols left undefined at link time
        cmd[2:2] = ["-undefined", "dynamic_lookup"]
    _compile("native flattener", "C", cmd, so)


def _load(so: Path):
    spec = importlib.util.spec_from_file_location("_flatten_native", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_frontend(out_dir: Optional[Path] = None) -> Path:
    """-> the path of the bridge_frontend executable, building it first
    unless its artifact is there: into `out_dir` when given, else
    through the store (kernels/build.py resolve) or into NATIVE_DIR.
    Raises RuntimeError, with the compiler's output, when the build
    fails."""
    name = _artifact_name(FRONTEND_SOURCE, "bridge_frontend", "")
    if out_dir is None:
        return resolve(name, _compile_frontend, NATIVE_DIR)
    exe = Path(out_dir) / name
    if not exe.exists():
        exe.parent.mkdir(parents=True, exist_ok=True)
        _compile_frontend(exe)
    return exe


def _compile_frontend(exe: Path) -> None:
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, "-O2", "-std=c++17", "-pthread", str(FRONTEND_SOURCE)]
    _compile("bridge frontend", "C++", cmd, exe)


def _artifact_name(source: Path, stem: str, suffix: str) -> str:
    """Content-addressed artifact name: any source edit rebuilds."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return f"{stem}_{tag}{suffix}"


def _compile(what: str, lang: str, cmd, out: Path) -> None:
    """Run `cmd -o <temp>` and install the result at `out`; raise
    RuntimeError with the compiler's output on failure."""
    # unique temp name: concurrent builds (test workers) must not clobber
    # each other mid-write (os.replace makes the install atomic); the
    # leading dot keeps it out of the store's attest()
    tmp = out.parent / f".{out.name}.build.{os.getpid()}"
    cmd = [*cmd, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(
            f"{what}: cannot run the {lang} compiler {cmd[0]!r}: {e}"
        ) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{what}: {' '.join(cmd)} failed (rc "
            f"{proc.returncode}):\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, out)
