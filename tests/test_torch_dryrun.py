"""The port's dry-run (``python -m repro_torch.launch.dryrun``) on ``meta``.

The CLI over the reference tests' cells (``tests/test_distributed.py``:
tiny, tiny-moe and tiny-ssm ``train_4k`` and tiny ``decode_32k`` on
``2x4:data,model``, and the ``2x2x2:pod,data,model`` mesh whose gradient
sync must plan collectives); ``--all`` enumerating exactly
``all_cells()`` times the meshes with the reference's skip reasons; the
flags that only steer XLA refused; ``model_flops_total`` equal to the
reference's record for one cell (the reference in a forced 8-device
subprocess, hence ``slow``); and the mesh step's batch cut, which keeps
the M-RoPE ids' batch along their dim 1.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs.registry import cell_is_applicable as j_applicable

from repro_torch.configs.base import SHAPES, ShapeConfig, TrainConfig
from repro_torch.configs.registry import (ARCHS, all_cells,
                                          cell_is_applicable, get_config)
from repro_torch.launch import dryrun
from repro_torch.models import init_params
from repro_torch.roofline.analysis import Roofline
from repro_torch.train.train_step import _local_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _run(args, module="repro_torch.launch.dryrun", env_extra=None,
         timeout=300):
    env = {**os.environ, "PYTHONPATH": SRC, **(env_extra or {})}
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-m", module] + args, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _record(tmp_path):
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    return json.loads(files[0].read_text())


@pytest.mark.parametrize("arch,shape", [
    ("tiny", "train_4k"),
    ("tiny-moe", "train_4k"),
    ("tiny-ssm", "train_4k"),
    ("tiny", "decode_32k"),
])
def test_dryrun_small_mesh(arch, shape, tmp_path):
    r = _run(["--arch", arch, "--shape", shape, "--mesh", "2x4:data,model",
              "--out", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout
    rec = _record(tmp_path)
    assert rec["ok"]
    assert rec["flops_per_device"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert (rec["device"], rec["model_axis"]) == ("meta", "replicated")
    assert rec["memory"]["peak_live_bytes"] >= \
        rec["memory"]["argument_size_in_bytes"] > 0
    want_keys = set(Roofline.__dataclass_fields__) | {"memory", "ok",
                                                      "hlo_chars"}
    assert want_keys <= set(rec)


def test_dryrun_multipod_axes(tmp_path):
    """pod axis shards the batch: 2x2x2 pod,data,model; the gradient
    sync plans one all-reduce a gradient leaf and one for the loss, and
    ZeRO-1 an all-gather of each cut leaf."""
    r = _run(["--arch", "tiny", "--shape", "train_4k",
              "--mesh", "2x2x2:pod,data,model", "--out", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    rec = _record(tmp_path)
    assert rec["ok"], rec.get("error")
    assert rec["coll_operand_bytes"] > 0
    n_leaves = len(torch.utils._pytree.tree_leaves(
        init_params(get_config("tiny"), device="meta")))
    assert rec["coll_counts"]["all-reduce"] == n_leaves + 1
    assert 0 < rec["coll_counts"]["all-gather"] <= n_leaves


def test_all_enumerates_the_cells_with_the_reference_reasons(
        tmp_path, monkeypatch, capsys):
    def stub(arch, shape, mesh_kind, tcfg, bucketed=False):
        roof = Roofline(arch, shape, mesh_kind, 1, 1.0, 1.0, 0.0, 0.0, {},
                        1.0).finalize()
        return roof, {}, {}

    monkeypatch.setattr(dryrun, "lower_cell", stub)
    assert dryrun.main(["--all", "--mesh", "both", "--out",
                        str(tmp_path)]) == 0
    recs = [json.loads(f.read_text()) for f in tmp_path.glob("*.json")]
    ok = sorted((r["arch"], r["shape"], r["mesh"]) for r in recs
                if r.get("ok"))
    assert ok == sorted((a, s, m) for a, s in all_cells()
                        for m in ("single", "multi"))
    # a skipped cell is printed, not recorded, as in the reference
    skipped = [line[len("SKIP "):].split(": ", 1)
               for line in capsys.readouterr().out.splitlines()
               if line.startswith("SKIP ")]
    assert len(ok) + len(skipped) == len(ARCHS) * len(SHAPES) * 2
    for tag, why in skipped:
        arch, shape, _ = tag.split("|")
        assert j_applicable(arch, shape) == (False, why)
        assert cell_is_applicable(arch, shape) == (False, why)


@pytest.mark.parametrize("flags", [
    ["--attn", "blockwise"],
    ["--remat-policy", "dots"],
    ["--no-qkv-shard"],
    ["--no-seq-parallel"],
    ["--save-hlo", "out.hlo"],
])
def test_xla_only_flags_exit_non_zero(flags, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "tiny", "--out", str(tmp_path)] + flags)
    assert e.value.code != 0
    assert "not supported by the PyTorch port" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.json"))


@pytest.mark.parametrize("policy,remat", [("full", True), ("none", False)])
def test_remat_policy_maps_to_remat(policy, remat, tmp_path, monkeypatch):
    seen = []

    def stub(arch, shape, mesh_kind, tcfg, bucketed=False):
        seen.append(tcfg.remat)
        return Roofline(arch, shape, mesh_kind, 1, 1.0, 1.0, 0.0, 0.0, {},
                        1.0).finalize(), {}, {}

    monkeypatch.setattr(dryrun, "lower_cell", stub)
    dryrun.main(["--arch", "tiny", "--remat-policy", policy, "--out",
                 str(tmp_path)])
    assert seen == [remat]


def test_bucketed_plans_one_all_reduce_a_bucket():
    roof, mem, meta = dryrun.lower_cell(
        "tiny", ShapeConfig("small", 64, 8, "train"), "2x2:data,model",
        TrainConfig(param_dtype="bfloat16", grad_bucket_mb=16.0),
        bucketed=True)
    # tiny's grads fit one 16 MiB bucket: its all-reduce and the loss's
    assert roof.coll_counts == {"all-reduce": 2}
    assert meta["kernels"]["flash_attention"]["calls"] == 2 * 2


def test_mesh_step_cuts_mrope_ids_along_their_batch_dim():
    """``make_train_step(mesh=)`` gives each rank its rows of every batch
    leaf: the M-RoPE ids (3, B, S) along dim 1 (they were cut along dim
    0, the three id rows)."""
    batch = {"tokens": torch.arange(4 * 6).reshape(4, 6),
             "mrope_positions": torch.arange(3 * 4 * 6).reshape(3, 4, 6)}
    part = _local_batch(batch, 1, 2)
    assert torch.equal(part["tokens"], batch["tokens"][2:4])
    assert torch.equal(part["mrope_positions"],
                       batch["mrope_positions"][:, 2:4])
    fn, _, plan = dryrun.build_cell(
        get_config("qwen2-vl-7b-smoke"), ShapeConfig("t", 32, 4, "train"),
        dryrun.mesh_config("2:data"), TrainConfig(zero1=False))
    loss, _, _ = fn()
    assert loss.device.type == "meta" and loss.shape == ()
    assert [op for op, _, _ in plan.collectives].count("all-reduce") > 0


@pytest.mark.slow
def test_model_flops_total_equals_the_reference_record(tmp_path):
    ours, ref = tmp_path / "port", tmp_path / "ref"
    r = _run(["--arch", "tiny", "--shape", "train_4k", "--mesh",
              "2x4:data,model", "--out", str(ours)])
    assert r.returncode == 0, r.stdout + r.stderr
    r = _run(["--arch", "tiny", "--shape", "train_4k", "--mesh",
              "2x4:data,model", "--out", str(ref)],
             module="repro.launch.dryrun", env_extra={"DRYRUN_DEVICES": "8"},
             timeout=560)
    assert r.returncode == 0, r.stdout + r.stderr
    got, want = _record(ours), _record(ref)
    assert got["model_flops_total"] == want["model_flops_total"]
    assert (got["chips"], got["arch"], got["shape"]) == \
        (want["chips"], want["arch"], want["shape"])
