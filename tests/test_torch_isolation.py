"""The port stands alone: gatekeeper_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, and the port's entry points run on the
card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gatekeeper_tpu_torch")


def _modules():
    out = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gatekeeper_tpu")


def test_import_pulls_in_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest),
    importing every module of the port loads no jax* and no
    gatekeeper_tpu.* module."""
    mods = _modules()
    assert len(mods) > 30
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'gatekeeper_tpu'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_jax_import_statements():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert bad == []


def test_driver_without_cuda_raises(monkeypatch):
    from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDriver()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDriver("cuda")
    assert TorchDriver(device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device (and, separately, without the package beside
    it) chip_smoke.py exits nonzero and prints no result line."""
    runs = []
    if not torch.cuda.is_available():
        runs.append(ROOT)
    lone = tmp_path / "alone"
    lone.mkdir()
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (lone / "chip_smoke.py").write_text(f.read())
    runs.append(str(lone))
    for cwd in runs:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
