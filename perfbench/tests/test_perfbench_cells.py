"""Each cell's small stand-in run through the harness on the CPU: the
port's share against the plain reference (``correct`` true within the
cell's limits), the result line's keys, and a traced run's per-layer
metrics."""
import math

import pytest

from perfbench.tests import smoke


@pytest.mark.parametrize("which", ["deepseek", "hymba", "hymba_prefill"])
def test_share_matches_reference(which):
    out = smoke.run(which, seed=3_000_000_007)
    assert out["correct"], out["checked"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checked"}
    for name, v in out["checked"].items():
        assert math.isfinite(v["value"]) and v["value"] <= v["limit"], name
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("which,names", [
    ("deepseek", {"mfu.prefill"}),
    ("hymba_prefill", {"mfu.prefill"}),
    ("hymba", {"mfu.decode", "hbm_roofline.decode"})])
def test_traced_run(which, names):
    out = smoke.run(which, trace=True)
    assert out["correct"], out["checked"]
    assert names <= set(out["metrics"])
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
