"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source in csrc/ compiles into its own shared library with a plain C
interface (`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`), under build/gatekeeper_tpu_torch/ at the repository
root. A library's file name carries a hash of its source, so an edited
source rebuilds and an unchanged one loads what is there. `build_all`
starts one nvcc per source at once; `library(name)` builds on first use.
Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gatekeeper_tpu_torch"
SOURCES = ("match", "slab", "group", "need", "delta", "gather", "totals")
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points (every pointer and the stream as void*)
_SIGNATURES = {
    "match": ("gk_match_matrix", [_P, _P, _P]),
    "slab": ("gk_slab_gather", [_P, _I, _P, _I, _P, _I, _P,
                                ctypes.c_longlong, _I, _I, _I, _I, _I, _P]),
    "group": ("gk_egroup", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, ctypes.c_float, _P, _I, _I, _I, _I, _I, _P]),
    "need": ("gk_need_tail", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "delta": ("gk_flush_deltas", [_P, _P, ctypes.c_longlong, _I, _P]),
    "gather": ("gk_gather_elem", [_P, _I, _P, _P, _I, _I, ctypes.c_uint,
                                  _P, ctypes.c_longlong, _I, _I, _P]),
    "empty": ("gk_empty", [_I, _I, _P]),  # the launch floor (probe only)
    "totals": ("gk_full_totals", [_P, _P, _I, _P, _I, ctypes.c_longlong,
                                  ctypes.c_longlong, _P, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + ARCH.encode()).hexdigest()[:12]
    return BUILD_DIR / f"libgk_{name}_{digest}.so"


def _command(name: str, out: Path) -> List[str]:
    return [
        nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every library not yet built, one nvcc per source, all
    started together. Returns {name: compiler output} for what was
    compiled (ptxas register and shared-memory lines); raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
            out,
        )
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build_all([name])
            lib = ctypes.CDLL(str(out))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib
