"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the engine's default device is the
GPU (it raises rather than fall back to the CPU)."""
import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "src"

_CHILD = r"""
import importlib, pkgutil, sys
import torch
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                             "repro_torch.")]
for name in mods:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "repro" or m.startswith(("repro.", "jax", "jaxlib")))
assert not bad, bad
from repro_torch.core.rdma import RDMAEngine
if torch.cuda.is_available():
    assert RDMAEngine(pool_size=64).pool.device.type == "cuda"
else:
    try:
        RDMAEngine(pool_size=64)
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("RDMAEngine() without a GPU did not raise")
print("IMPORTED", len(mods))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_imports_no_jax_and_no_reference_package():
    r = subprocess.run([sys.executable, "-c", _CHILD], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "IMPORTED" in r.stdout
    assert int(r.stdout.split("IMPORTED")[1]) >= 25


def _imported_names(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_source_file_names_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for name in _imported_names(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, name)


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Without CUDA the smoke script fails and prints no result line."""
    import torch
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, env=_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
