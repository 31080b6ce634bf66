"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell finds by name present: configuration, traffic, limits, reference
and metric readers. On a card (skipped elsewhere), each cell run once,
briefly, through ``run.py``."""
import json
import re
import subprocess
import sys

import pytest

from perfbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cells_find_their_files():
    metrics = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for conf in BENCH["configs"]:
        data = harness.load_json(harness.ROOT / conf["file"])
        assert conf["file"].startswith("perfbench/")
        assert all(k in data and k in data["published"]
                   for k in conf["reduced"])
        assert (harness.HERE / "reference"
                / f"{data['reference']}.py").exists()
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1
        assert (harness.HERE / "traffic" / f"{cell['traffic']}.json").exists()
        limits = harness.load_json(harness.HERE / "limits"
                                   / f"{cell['name']}.json")["numbers"]
        assert all(v["lower"] < v["limit"] < v["upper"]
                   for v in limits.values())
        seen = {m["name"] for m in metrics.values()
                if cell["name"] in m.get("workloads", [cell["name"]])}
        assert "setup_s" in seen and len(seen) >= 3
    for m in BENCH["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in metrics and "bound" not in m
        assert set(m["workloads"]) <= set(metrics[m["moves"]].get(
            "workloads", m["workloads"]))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_states_the_port(name):
    """Each configuration file states the port's config as its share
    runs it; a departure stated other than the port runs it raises."""
    from repro_torch.configs.registry import get_config
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    conf = harness.load_json(harness.ROOT / entry["file"])
    assert entry["reduced"] == conf["reduced"]
    cfg = get_config(conf["arch"])
    n = conf["mesh"]["shape"][conf["mesh"]["axes"].index("model")]
    harness.check_config(conf, cfg, n)
    for key, value in conf.get("as_run", {}).items():
        wrong = {**conf, "as_run": {**conf["as_run"], key: (
            not value if isinstance(value, bool) else value[:-1])}}
        with pytest.raises(ValueError):
            harness.check_config(wrong, cfg, n)


def test_check_time_fits():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "3000000017", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checked"]
