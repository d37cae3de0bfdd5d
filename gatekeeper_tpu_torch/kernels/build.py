"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source in csrc/ compiles into its own shared library with a plain C
interface (`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`), under build/gatekeeper_tpu_torch/ at the repository
root. A library's file name carries a hash of its source, so an edited
source rebuilds and an unchanged one loads what is there. `build_all`
starts one nvcc per source at once; `library(name)` builds on first use.
Nothing is built or loaded when this module is imported.

With the compile-artifact store on (compile/, `process_store()`; the
default unless GATEKEEPER_TPU_NO_COMPILE_CACHE=1) the libraries live in
the store's per-fingerprint lib dir instead: a library adopted from the
store's artifacts is loaded from there, and only a library no artifact
covers is built, into that dir, and attested. `resolve()` does the same
for the native host libraries (native/).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

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
# name -> (library, the path it was loaded from, the store's revocation
# count when it was loaded)
_libs: Dict[str, Tuple[ctypes.CDLL, str, int]] = {}
_store_lock = threading.Lock()
_store: List = []  # [the process's ProgramStore or None], once made


def nvcc_path() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    return str(cand) if cand.exists() else None


def nvcc() -> str:
    found = nvcc_path()
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def process_store():
    """The process's compile-artifact store (compile.store_from_env, made
    on first use), or None when GATEKEEPER_TPU_NO_COMPILE_CACHE=1."""
    if not _store:
        with _store_lock:
            if not _store:
                from ..compile import store_from_env

                _store.append(store_from_env())
    return _store[0]


def _filename(name: str) -> str:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + ARCH.encode()).hexdigest()[:12]
    return f"libgk_{name}_{digest}.so"


def _out_dir(store) -> Path:
    return Path(store.lib_dir) if store is not None else BUILD_DIR


def _target(name: str) -> Path:
    """Where the library for csrc/<name>.cu is loaded from."""
    return _out_dir(process_store()) / _filename(name)


def _built(store, filename: str) -> bool:
    if store is not None:
        return store.lookup(filename) is not None
    return (BUILD_DIR / filename).exists()


def resolve(filename: str, compile_to: Callable[[Path], None],
            plain_dir: Path) -> Path:
    """The path to load `filename` from. With the store on: the adopted
    or attested file in its lib dir, else `compile_to(path)` builds it
    there (atomically) and the store attests it. Without a store:
    `plain_dir/filename`, built first if it is not there."""
    store = process_store()
    out_dir = Path(store.lib_dir) if store is not None else Path(plain_dir)
    out = out_dir / filename
    if store is not None:
        found = store.lookup(filename)
        if found is not None:
            return Path(found)
    elif out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    compile_to(out)
    if store is None:
        return out
    store.note_miss()
    store.attest()
    found = store.lookup(filename)
    if found is None:
        raise RuntimeError(
            f"{filename}: built into {out_dir} but not attested by the "
            "store"
        )
    return Path(found)


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
    compiler's output if any build fails. With the store on, a library
    the store holds for this machine is not compiled, and what is
    compiled is attested."""
    store = process_store()
    out_dir = _out_dir(store)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        filename = _filename(name)
        if _built(store, filename):
            continue
        out = out_dir / filename
        tmp = out_dir / f".{filename}.{os.getpid()}.tmp"
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
            if store is not None:
                store.note_miss()
    if store is not None and procs:
        store.attest()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed. A
    library loaded from a store artifact that the store has since
    revoked raises: this process does not launch it again."""
    ent = _libs.get(name)
    if ent is not None:
        store = _store[0] if _store else None
        if store is None or ent[2] == store.revocations:
            return ent[0]
    with _lock:
        store = process_store()
        ent = _libs.get(name)
        if ent is not None:
            # the store revoked something since this library was loaded
            if store.lookup(os.path.basename(ent[1])) != ent[1]:
                raise RuntimeError(
                    f"{ent[1]}: the compile-artifact store revoked this "
                    "library after it was loaded; restart the process"
                )
            _libs[name] = (ent[0], ent[1], store.revocations)
            return ent[0]
        filename = _filename(name)
        if not _built(store, filename):
            build_all([name])
        out = (
            store.lookup(filename) if store is not None
            else str(BUILD_DIR / filename)
        )
        if out is None:
            raise RuntimeError(f"{filename}: not in the store after its build")
        lib = ctypes.CDLL(out)
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = (lib, out, store.revocations if store else 0)
    return lib
