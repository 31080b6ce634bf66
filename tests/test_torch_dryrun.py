"""The port's dry-run (``python -m repro_torch.launch.dryrun``) on ``meta``.

The CLI over the reference tests' cells (``tests/test_distributed.py``:
tiny, tiny-moe and tiny-ssm ``train_4k`` and tiny ``decode_32k`` on
``2x4:data,model``, and the ``2x2x2:pod,data,model`` mesh whose gradient
sync must plan collectives); ``--all`` enumerating exactly
``all_cells()`` times the meshes with the reference's skip reasons; the
flags that only steer XLA refused; ``model_flops_total`` equal to the
reference's record for one cell (the reference in a forced 8-device
subprocess, hence ``slow``); the mesh step's batch cut, which keeps
the M-RoPE ids' batch along their dim 1; and ``--attn blockwise``
(``--attn-chunk``): a record naming them, a peak below the naive one's,
the caller's impl restored; and a ``tiny-moe`` cell over a model axis
its experts do not divide, which lowers with the experts whole and lists
them in its record.
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
from repro_torch.models.layers import (get_attention_chunk, get_attention_impl,
                                       set_attention_impl)
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
    # every family's model axis is cut, and a cut share is the axis's
    # last rank
    assert (rec["device"], rec["model_axis"]) == ("meta", "sharded")
    assert rec["model_rank"] == 3
    assert rec["memory"]["peak_live_bytes"] >= \
        rec["memory"]["argument_size_in_bytes"] > 0
    want_keys = set(Roofline.__dataclass_fields__) | {"memory", "ok",
                                                      "hlo_chars"}
    assert want_keys <= set(rec)


def test_dryrun_multipod_axes(tmp_path):
    """pod axis shards the batch: 2x2x2 pod,data,model; the gradient
    sync over (pod, data) plans one all-reduce a gradient leaf and one
    for the loss, and ZeRO-1 an all-gather of each cut leaf (tiny's
    leaves cut over model)."""
    r = _run(["--arch", "tiny", "--shape", "train_4k",
              "--mesh", "2x2x2:pod,data,model", "--out", str(tmp_path)])
    assert r.returncode == 0, r.stdout + r.stderr
    rec = _record(tmp_path)
    assert rec["ok"], rec.get("error")
    assert rec["coll_operand_bytes"] > 0
    n_leaves = len(torch.utils._pytree.tree_leaves(
        init_params(get_config("tiny"), device="meta")))
    dp = rec["collectives"]["pod,data"]
    assert dp["all-reduce"]["count"] == n_leaves + 1
    assert 0 < dp["all-gather"]["count"] <= n_leaves
    assert rec["model_axis"] == "sharded" and "model" in rec["collectives"]


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
    ["--save-hlo", "out.hlo"],
])
def test_xla_only_flags_exit_non_zero(flags, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "tiny", "--out", str(tmp_path)] + flags)
    assert e.value.code != 0
    assert "not supported by the PyTorch port" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.json"))


@pytest.mark.parametrize("flags,knob", [
    (["--remat-policy", "dots"], {"remat_policy": "dots"}),
    (["--no-qkv-shard"], {"qkv_shard": False}),
])
def test_reference_lowering_flags_run(flags, knob, tmp_path):
    """The reference's ``--remat-policy dots`` and ``--no-qkv-shard`` run
    on a cut ``tiny`` train cell (4 q over 2 KV heads at a model axis of
    2: heads) and name themselves in its record."""
    assert dryrun.main(["--arch", "tiny", "--shape", "train_4k", "--mesh",
                        "2x2:data,model", "--out", str(tmp_path)]
                       + flags) == 0
    rec = _record(tmp_path)
    assert rec["ok"], rec.get("error")
    assert {k: rec[k] for k in knob} == knob


@pytest.mark.parametrize("sp", [True, False])
def test_no_seq_parallel_runs_the_residual_whole(sp, tmp_path):
    """tiny's train cell on 2x2:data,model (heads over the model axis):
    sequence parallelism reduce-scatters the residual and gathers it back
    over ``model``; ``--no-seq-parallel`` keeps it whole and all-reduces
    the blocks' outputs instead."""
    flags = [] if sp else ["--no-seq-parallel"]
    assert dryrun.main(["--arch", "tiny", "--shape", "train_4k", "--mesh",
                        "2x2:data,model", "--out", str(tmp_path)]
                       + flags) == 0
    rec = _record(tmp_path)
    assert rec["ok"], rec.get("error")
    model = rec["collectives"]["model"]
    assert ("reduce-scatter" in model) == sp
    assert ("all-gather" in model) == sp


def test_qwen2_5_3b_train_4k_share_fits_the_card():
    """One device's share of qwen2.5-3b's ``train_4k`` on the single-pod
    mesh, cut over the model axis as the reference cuts it, peaks under
    the H100's 85.02 GB on ``meta`` (178.18 GB with the axis
    replicated)."""
    roof, mem, meta = dryrun.lower_cell("qwen2.5-3b", "train_4k", "single",
                                        dryrun.train_config())
    assert meta["model_axis"] == "sharded" and meta["model_rank"] == 15
    assert 0 < mem["peak_live_bytes"] < 85.02e9
    assert set(meta["collectives"]) == {"data", "model"}


def test_plan_ranks_follow_the_coordinate():
    """A ``PlanMesh`` at a coordinate: each group's rank is the
    coordinate's index in it (row-major over its axes), and a plan's
    reduce-scatter and all-to-all keep that rank's cut."""
    from repro_torch.launch.mesh import (PlanMesh, all_to_all, group_rank,
                                         model_rank, reduce_scatter)
    plan = PlanMesh((2, 4), ("data", "model"), (1, 3))
    assert model_rank(plan) == 3
    assert group_rank(plan.group(("model",))) == 3
    assert group_rank(plan.group(("data",))) == 1
    assert group_rank(plan.group(("data", "model"))) == 7
    t = torch.arange(8.0).reshape(1, 8)
    g = plan.group(("model",))
    assert torch.equal(reduce_scatter(t, g, 1), t[:, 6:8])
    assert torch.equal(all_to_all(t, g, 1, 0), t[:, 6:8].repeat(4, 1))
    assert group_rank(PlanMesh((2, 4), ("data", "model")).group(
        ("model",))) == 0


def test_decode_share_reads_its_cache_cut_where_it_lies():
    """tiny's ``decode_32k`` share on 2x4:data,model (the cache cut on
    the head dim): the step all-reduces its partial scores and gathers
    q and its output over ``model``; no all-gather carries anything near
    a layer's cut of the K cache, and all it sends over ``model`` is an
    eighth of the whole K and V (4 q heads' f32 scores a position
    against 2 KV heads of 16 in bf16, both K and V), and the small
    gathers of q and the output beside."""
    cfg = get_config("tiny")
    fn, (_, _, caches), plan = dryrun.build_cell(
        cfg, SHAPES["decode_32k"], dryrun.mesh_config("2x4:data,model"),
        dryrun.train_config())
    fn()
    k = caches["scan"]["k"]
    cut_bytes = k.numel() * k.element_size()
    sent = [(op, nbytes) for (op, nbytes, _), ax in
            zip(plan.collectives, plan.collective_axes) if ax == ("model",)]
    assert {op for op, _ in sent} == {"all-reduce", "all-gather"}
    gathered = max(nbytes for op, nbytes in sent if op == "all-gather")
    assert gathered * 1000 <= cut_bytes // cfg.num_layers
    # the whole K and V: 4 ranks' cuts of each
    assert sum(nbytes for _, nbytes in sent) * 8 <= 2 * 4 * cut_bytes * 1.01


@pytest.mark.parametrize("chunk", [1024, 2048])
def test_blockwise_attn_writes_a_record_naming_it(chunk, tmp_path):
    """``--attn blockwise --attn-chunk N`` traces the cell under the
    blockwise impl and names the two in its record; the impl is
    ``"naive"`` again once ``main`` returns."""
    assert dryrun.main(["--arch", "tiny", "--shape", "train_4k", "--attn",
                        "blockwise", "--attn-chunk", str(chunk), "--out",
                        str(tmp_path)]) == 0
    rec = _record(tmp_path)
    assert rec["ok"], rec.get("error")
    assert (rec["attn"], rec["attn_chunk"]) == ("blockwise", chunk)
    assert get_attention_impl() == "naive"


def test_naive_record_names_no_attn(tmp_path):
    assert dryrun.main(["--arch", "tiny", "--shape", "train_4k", "--out",
                        str(tmp_path)]) == 0
    rec = _record(tmp_path)
    assert rec["ok"] and "attn" not in rec and "attn_chunk" not in rec


def test_blockwise_peak_is_below_the_naive_peak(tmp_path):
    """tiny at ``train_4k`` (16 x 4096 a device): the blockwise backward
    holds one chunk's scores where the plain one holds all 4096 keys'."""
    peaks = {}
    for attn in ("naive", "blockwise"):
        out = tmp_path / attn
        assert dryrun.main(["--arch", "tiny", "--shape", "train_4k",
                            "--attn", attn, "--out", str(out)]) == 0
        peaks[attn] = _record(out)["memory"]["peak_live_bytes"]
    assert peaks["blockwise"] < peaks["naive"]


def test_main_restores_the_callers_impl(tmp_path, monkeypatch):
    """``main`` restores the impl and chunk it found, also when a cell
    raises past ``run_cell``."""
    def boom(*a, **kw):
        assert get_attention_impl() == "blockwise"
        raise KeyboardInterrupt

    monkeypatch.setattr(dryrun, "run_cell", boom)
    set_attention_impl("naive", 512)
    try:
        with pytest.raises(KeyboardInterrupt):
            dryrun.main(["--arch", "tiny", "--attn", "blockwise",
                         "--out", str(tmp_path)])
        assert (get_attention_impl(), get_attention_chunk()) == ("naive", 512)
    finally:
        set_attention_impl("naive")


@pytest.mark.parametrize("policy,remat", [("full", True), ("none", True),
                                          ("dots", True)])
def test_remat_policy_maps_to_remat(policy, remat, tmp_path, monkeypatch):
    """``--remat-policy`` leaves ``TrainConfig.remat`` as the reference's
    dry-run sets it (``not --no-remat``) and runs the cells under the
    policy (``none`` then checkpoints nothing), restoring it after."""
    from repro_torch.models import transformer
    seen = []

    def stub(arch, shape, mesh_kind, tcfg, bucketed=False):
        seen.append((tcfg.remat, transformer.get_remat_policy()))
        return Roofline(arch, shape, mesh_kind, 1, 1.0, 1.0, 0.0, 0.0, {},
                        1.0).finalize(), {}, {}

    monkeypatch.setattr(dryrun, "lower_cell", stub)
    dryrun.main(["--arch", "tiny", "--remat-policy", policy, "--out",
                 str(tmp_path)])
    assert seen == [(remat, policy)]
    assert transformer.get_remat_policy() == "full"


def test_bucketed_plans_one_all_reduce_a_bucket():
    roof, mem, meta = dryrun.lower_cell(
        "tiny", ShapeConfig("small", 64, 8, "train"), "2x2:data,model",
        TrainConfig(param_dtype="bfloat16", grad_bucket_mb=16.0),
        bucketed=True)
    # tiny's grads fit one 16 MiB bucket: its all-reduce and the loss's
    # over data; the model axis's own collectives beside them
    counts = {g: {op: c["count"] for op, c in ops.items()}
              for g, ops in meta["collectives"].items()}
    assert counts["data"] == {"all-reduce": 2}
    assert set(counts) == {"data", "model"}
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


def test_whole_experts_lower_on_meta(tmp_path):
    """``tiny-moe``'s 4 experts over a model axis of 8, which they do not
    divide: the cell lowers on ``meta`` (every rank holds all of them, as
    the reference's ``sanitize_specs`` leaves them), its record lists
    the three whole expert stacks with their bytes, and its arguments,
    and so its peak, count them at their whole size."""
    assert dryrun.main(["--arch", "tiny-moe", "--shape", "train_4k",
                        "--mesh", "2x8:data,model", "--out",
                        str(tmp_path)]) == 0
    rec = _record(tmp_path)
    assert rec["ok"], rec.get("error")
    cfg = get_config("tiny-moe")
    stacks = [f"layers/ffn/moe/experts/{w}"
              for w in ("w_down", "w_gate", "w_up")]
    assert rec["whole_leaves"]["paths"] == stacks
    assert rec["whole_leaves"]["count"] == 3
    each = (cfg.num_layers * cfg.moe.num_experts * cfg.d_model
            * cfg.moe.expert_d_ff * 2)                      # bf16
    assert rec["whole_leaves"]["bytes"] == 3 * each
    share = init_params(cfg, 0, torch.bfloat16, "meta", tp_rank=7,
                        tp_size=8)
    held = sum(t.numel() * t.element_size() for t in
               torch.utils._pytree.tree_leaves(share))
    assert held > 3 * each
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] >= held
    assert mem["peak_live_bytes"] >= mem["argument_size_in_bytes"]
