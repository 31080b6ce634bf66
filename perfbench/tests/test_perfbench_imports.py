"""Nothing the harness loads is the JAX package or JAX: in a fresh
interpreter, after loading every module a run loads (the harness, the
drivers, the references, the metric readers and the port's modules they
call), no top-level module name (compared whole) is ``jax``, ``jaxlib``,
``flax`` or ``repro``."""
import json
import os
import subprocess
import sys
import types

from perfbench import harness

PROBE = r"""
import importlib, json, sys
from pathlib import Path
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from perfbench import harness, trace, counts, calibrate
for name in ("prefill", "decode"):
    importlib.import_module("perfbench.kinds." + name)
for p in sorted((harness.HERE / "reference").glob("*.py")):
    importlib.import_module("perfbench.reference." + p.stem)
for p in sorted((harness.HERE / "metrics").glob("*.py")):
    harness.load_module(p)
for name in ("repro_torch.serve.serve_step", "repro_torch.models.transformer",
             "repro_torch.configs.registry", "repro_torch.launch.mesh",
             "repro_torch.models.sharding"):
    importlib.import_module(name)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_no_jax_in_a_run():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE, str(harness.ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "perfbench" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(
        ["repro_torch.models", "jaxtyping", "reprox", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["repro.models.layers", "jax.numpy", "torch"]) == ["jax", "repro"]


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(harness, "execute",
                        lambda *a, **k: {"checked": {}, "correct": True})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    argv = ["--workload", "any", "--seed", "1", "--seconds", "1"]
    assert harness.main(argv, 0.0) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err
