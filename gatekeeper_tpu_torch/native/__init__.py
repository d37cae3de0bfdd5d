# Copied from gatekeeper_tpu/native/__init__.py (:43-99); only these edits differ.
# Edit: the shared object is built into build/gatekeeper_tpu_torch/native/
# (beside the CUDA kernels, kernels/build.py's BUILD_DIR) instead of
# ~/.cache; a failed build or load raises with the compiler's output instead
# of returning None; the GATEKEEPER_TPU_NO_NATIVE switch and
# last_build_error are left out (the Python encoder runs only when the
# caller asks for it: encode_token_table(native=False),
# TorchDriver(encoder="python")).
"""Native host-side components of the port.

`flatten.c` is the C token flattener: a CPython extension that walks the
parsed objects and interns straight into the caller's Vocab, the
counterpart of the Python `flatten_leaves` + `encode_token_table`. It is
host code, not a device kernel. It is compiled with gcc (or $CC) on first
use into a shared object whose name carries a hash of the source, so an
edited source rebuilds; nothing is built when this module is imported.
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

from ..kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "flatten.c"
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
                _mod = load_or_build(NATIVE_DIR)
    return _mod


def load_or_build(out_dir: Path):
    """Build flatten.c into `out_dir` unless its artifact is there, then
    load it."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    # content-addressed artifact: any source edit rebuilds
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = out_dir / f"_flatten_native_{tag}{suffix}"
    if not so.exists():
        cc = os.environ.get("CC", "gcc")
        include = sysconfig.get_paths()["include"]
        # unique temp name: concurrent builds (test workers) must not
        # clobber each other mid-write (os.replace makes the install atomic)
        tmp = Path(f"{so}.build.{os.getpid()}")
        cmd = [cc, "-O2", "-shared", "-fPIC", f"-I{include}", str(SOURCE),
               "-o", str(tmp)]
        if sys.platform == "darwin":
            # clang needs the Python symbols left undefined at link time
            cmd[2:2] = ["-undefined", "dynamic_lookup"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(
                f"native flattener: cannot run the C compiler {cc!r}: {e}"
            ) from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native flattener: {' '.join(cmd)} failed (rc "
                f"{proc.returncode}):\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, so)
    spec = importlib.util.spec_from_file_location("_flatten_native", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
