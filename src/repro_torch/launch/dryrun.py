"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on ``meta``.

The port of ``repro/launch/dryrun.py``. For each cell it runs one
device's share of the step on PyTorch's ``meta`` device, where tensors
have shapes and dtypes but no memory and no op computes a number, under
``roofline.count.OpCounter``, and gives without hardware:

  * that the step runs at the cell's shapes (no shape or dtype fault),
  * whether it fits: the peak live bytes a device would hold,
  * its roofline terms against an H100 (``roofline.analysis``): FLOPs,
    bytes and the collectives the step would send.

A device's share follows what the port's steps do. The batch is split
over the ``pod`` x ``data`` axes where ``launch.specs.batch_partition``
allows (a ``long_500k`` cell's batch of 1 keeps its whole sequence on
every device). For every family (``models.sharding.model_axis_sharded``)
the ``model`` axis is the reference's: the share is the last rank of the
axis, the one that sequence-parallel attention loads most
(``share_rank``), and holds its cut of every parameter
(``init_params(tp_rank=, tp_size=)``, the cut of
``sanitize_specs(param_specs(...))``), of the optimizer state and of the
caches (K and V cut on the head dim, MLA's latent and rope key on their
feature dims, the SSM's conv on its channels and its state on its head
dim, as ``cache_partition_specs`` cuts them), and its step runs over the
plan's ``model`` group with the explicit collectives of
``models/sharding.py`` (sequence parallelism as the CLI says); each
record's ``model_axis`` says ``"sharded"`` (``"replicated"`` on a mesh
whose axis is 1) and its ``model_rank`` which rank the share is. An MoE
layer of a ``make_train_step`` share routes as data rank 0 of the global
batch, the plan's other ranks' expert counts stand-ins (copies of its
own; ``models.moe.global_routing``). A train cell runs
``make_train_step`` (forward, backward with ``remat`` as the config
says, clip, AdamW; ZeRO-1 cuts ``m`` and ``v`` over the data-parallel
ranks, within the model cut) or, with ``bucketed``, the psum step of
``make_bucketed_train_step``, on a ``launch.mesh.PlanMesh`` whose groups
record each collective the step would send (a gradient leaf's or
bucket's all-reduce, the loss's, ZeRO-1's parameter all-gather, the
model axis's all-reduces, all-gathers, reduce-scatters and all-to-alls;
shape-correct, so the share allocates their results) with no process
group; on one rank of a mesh with neither axis over 1 it is the plain
step with no mesh. Prefill and decode cells run ``serve/serve_step.py``'s
``prefill_step`` and ``decode_step`` (at the last cache slot), over the
model group where the axis is sharded. Each record holds its
collectives by op (count and operand bytes).

This is the one entry point of the port that takes no device: ``meta``
computes nothing, so no CUDA device is needed. ``build_cell`` builds the
same step on a real device with seeded inputs, so a trace there can be
set against this one (``chip_smoke.py`` phase 27). ``--attn blockwise
--attn-chunk N`` sets ``models.layers.set_attention_impl`` for the
cells, as the reference does: K6's backward, and attention over a cache,
then run the online softmax over chunks of N keys, and each record names
the two. ``--no-seq-parallel`` runs the train cells' residual whole on
every rank of the model group. ``--remat-policy`` sets
``models.transformer.set_remat_policy`` (``dots``: selective
checkpointing that keeps the products without batch dims; ``none``: no
checkpoint) and ``--no-qkv-shard`` ``models.sharding.set_qkv_sharding
(False)`` (heads that do not divide the model axis run on the ranks'
cuts of the head dim, the scores all-reduced), both restored after the
run and named in each record where they differ from the default.
``--save-hlo`` is refused (the port lowers no HLO), and there is no
``XLA_FLAGS`` or ``DRYRUN_DEVICES``.

Usage::

  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single --attn blockwise --attn-chunk 1024
  python -m repro_torch.launch.dryrun --arch tiny --shape train_4k \\
      --mesh 2x2:data,model --remat-policy dots
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional, Union

import numpy as np
import torch

from repro_torch._tree import tree_leaves
from repro_torch.configs.base import (MULTI_POD_MESH, SHAPES, SINGLE_POD_MESH,
                                      MeshConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.configs.registry import (ARCHS, cell_is_applicable,
                                          get_config)
from repro_torch.launch.mesh import PlanMesh, dp_size, model_size
from repro_torch.launch.specs import (local_shape, serve_input_specs,
                                      train_input_specs)
from repro_torch.models import init_params
from repro_torch.models import layers, sharding, transformer
from repro_torch.roofline.analysis import analyze
from repro_torch.roofline.count import OpCounter
from repro_torch.serve.serve_step import decode_step, prefill_step
from repro_torch.train.optimizer import init_adam, zero1_init
from repro_torch.train.train_step import (make_bucketed_train_step,
                                          make_train_step)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

def train_config(microbatches: int = 1, remat: bool = True,
                 zero1: bool = True, bucket_mb: float = 16.0,
                 sequence_parallel: bool = True) -> TrainConfig:
    """The ``TrainConfig`` of the dry-run's train cells (bf16, as the
    reference's dry-run); its defaults are the CLI's."""
    return TrainConfig(microbatches=microbatches, remat=remat, zero1=zero1,
                       grad_bucket_mb=bucket_mb, param_dtype="bfloat16",
                       sequence_parallel=sequence_parallel)


def model_axis(cfg: ModelConfig, mesh: MeshConfig) -> int:
    """The ``model`` axis a share of ``cfg`` on ``mesh`` is cut over: its
    size for a family the port shards, else 1 (replicated)."""
    tp = dict(zip(mesh.axes, mesh.shape)).get("model", 1)
    return tp if sharding.model_axis_sharded(cfg) else 1


def share_rank(cfg: ModelConfig, mesh: MeshConfig) -> int:
    """The rank of the model axis whose share a cell builds: the last
    (0 where the axis is replicated). Every rank does the same work but
    in sequence-parallel attention, where the last holds the last rows
    and sees the most keys of a causal mask, and sets the step's time."""
    return model_axis(cfg, mesh) - 1


def mesh_config(mesh_kind: str) -> MeshConfig:
    """'single' | 'multi' | custom 'S1xS2[xS3]:ax1,ax2[,ax3]'."""
    if mesh_kind == "single":
        return SINGLE_POD_MESH
    if mesh_kind == "multi":
        return MULTI_POD_MESH
    shape_s, axes_s = mesh_kind.split(":")
    shape = tuple(int(x) for x in shape_s.split("x"))
    axes = tuple(axes_s.split(","))
    if len(shape) != len(axes):
        raise ValueError(f"mesh {mesh_kind!r}: {len(shape)} sizes for "
                         f"{len(axes)} axes")
    return MeshConfig(shape, axes)


def _fill(specs: dict, cfg: ModelConfig, seed: int,
          ids: Optional[tuple] = None) -> dict:
    """Seeded values of the input ``specs`` on their device (meta specs
    pass through): token ids and labels in ``[lo, hi)`` of ``ids``
    (default the vocab), position ids counting from 0, N(0, 1) frames
    and patches."""
    if next(iter(specs.values())).device.type == "meta":
        return specs
    lo, hi = ids or (0, cfg.vocab_size)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in specs.items():
        if k == "mrope_positions":
            pos = torch.arange(v.shape[-1], dtype=torch.int32)
            out[k] = pos.expand(v.shape).contiguous().to(v.device)
        elif v.dtype == torch.int32:
            out[k] = torch.from_numpy(rng.integers(
                lo, hi, tuple(v.shape)).astype(np.int32)).to(v.device)
        else:
            out[k] = torch.from_numpy(rng.standard_normal(
                tuple(v.shape), dtype=np.float32)).to(v.device, v.dtype)
    return out


def _fill_caches(caches: dict, seed: int) -> dict:
    """A decode cell's caches with seeded N(0, 1) values in every float
    leaf (K/V, MLA's latent and rope key, SSM conv and state), drawn in
    place on their device by a ``torch.Generator``: a 32k cache is tens
    of GB, too much to draw on the host. Integer leaves (``pos``) and
    ``meta`` caches are left as they are."""
    leaves = [t for t in tree_leaves(caches) if t.is_floating_point()]
    if not leaves or leaves[0].device.type == "meta":
        return caches
    gen = torch.Generator(device=leaves[0].device)
    gen.manual_seed(seed)
    for t in leaves:
        t.normal_(generator=gen)
    return caches


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshConfig,
               tcfg: TrainConfig, bucketed: bool = False, device="meta",
               seed: int = 0):
    """One device's share of a cell: (fn, inputs, plan) where ``fn()``
    runs the step once on ``inputs`` (params, optimizer state or caches,
    the batch), all on ``device`` in ``tcfg.param_dtype``, and ``plan``
    is the ``PlanMesh`` whose ``collectives`` the step records; a train
    cell's ``fn.step`` is its step (``grad_norm`` after a run). On
    ``meta`` nothing is drawn; elsewhere params and inputs come from
    ``seed``. A sharded share is the last rank of the model axis
    (``share_rank``), and draws its cut at its own shape and its token
    ids and labels among the vocab rows it holds: the plan's all-reduce
    adds no other rank's rows, so a token outside them would embed to 0
    through every layer, where the RMS norms' gradient grows about 1 /
    sqrt(eps) a layer and a deep share's overflows. (A share whose rows
    all lie in the vocab's padding, as hymba-1.5b's last of 128, draws
    among them; a vocab the axis does not divide is whole on every rank,
    and its ids are the vocab's.)"""
    dtype = getattr(torch, tcfg.param_dtype)
    tp = model_axis(cfg, mesh)
    rank = share_rank(cfg, mesh)
    ids = None
    if tp > 1 and cfg.padded_vocab() % tp == 0:
        rows = cfg.padded_vocab() // tp
        lo, hi = rank * rows, (rank + 1) * rows
        # the padding alone where the share's rows lie past the vocab
        ids = (lo, min(hi, cfg.vocab_size) if lo < cfg.vocab_size else hi)
    params = init_params(cfg, seed, dtype, device, tp_rank=rank,
                         tp_size=tp)
    coord = [rank if a == "model" else 0 for a in mesh.axes]
    plan = PlanMesh(mesh.shape, mesh.axes, coord)
    if shape.kind == "train":
        batch = _fill(train_input_specs(cfg, shape, dtype, device), cfg,
                      seed + 1, ids)
        opt = init_adam(params)
        if bucketed:
            step = make_bucketed_train_step(cfg, tcfg, plan, sync="psum")
        elif dp_size(plan) > 1 or tp > 1:
            step = make_train_step(cfg, tcfg, plan)
            if tcfg.zero1:
                opt = zero1_init(opt, plan)
        else:
            step = make_train_step(cfg, tcfg)

        def fn():
            return step(params, opt, batch)
        fn.step = step
        return fn, (params, opt, batch), plan
    share = local_shape(shape, mesh)
    specs = serve_input_specs(cfg, share, shape.kind, dtype, device,
                              tp_size=tp)
    caches = specs.pop("caches")
    specs.pop("pos", None)
    batch = _fill(specs, cfg, seed + 1, ids)
    group = (sharding.TensorParallel(plan.group(("model",)), False)
             if tp > 1 else None)
    if shape.kind == "prefill":
        def fn():
            with torch.no_grad():
                return prefill_step(params, cfg, batch, caches, tp=group)
    else:
        _fill_caches(caches, seed + 2)
        extra = {k: v for k, v in batch.items() if k != "tokens"}

        def fn():
            with torch.no_grad():
                return decode_step(params, cfg, batch["tokens"], caches,
                                   share.seq_len - 1, extra=extra or None,
                                   tp=group)
    return fn, (params, batch, caches), plan


def trace(fn, inputs) -> dict:
    """``fn()`` under an ``OpCounter`` of ``inputs``: its ``totals()``
    and ``output_bytes``, the bytes of the new storages it returns."""
    with OpCounter(inputs) as counter:
        out = fn()
    held = {t.untyped_storage()._cdata for t in tree_leaves(inputs)
            if isinstance(t, torch.Tensor)}
    new = {}
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            if s._cdata not in held:
                new[s._cdata] = s.nbytes()
    return {**counter.totals(), "output_bytes": sum(new.values())}


def lower_cell(arch: str, shape: Union[str, ShapeConfig], mesh_kind: str,
               tcfg: TrainConfig, bucketed: bool = False):
    """Trace one cell on ``meta``; returns (roofline, memory dict, meta
    dict). ``shape`` is a name in ``SHAPES`` or a ``ShapeConfig``."""
    cfg = get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = mesh_config(mesh_kind)
    t0 = time.time()
    fn, inputs, plan = build_cell(cfg, shape, mesh, tcfg, bucketed)
    counts = trace(fn, inputs)
    trace_s = time.time() - t0
    mem = {"argument_size_in_bytes": counts["input_bytes"],
           "output_size_in_bytes": counts["output_bytes"],
           "temp_size_in_bytes": (counts["peak_bytes"] - counts["input_bytes"]
                                  - counts["output_bytes"]),
           "alias_size_in_bytes": 0,
           "generated_code_size_in_bytes": 0,
           "peak_live_bytes": counts["peak_bytes"]}
    roof = analyze(arch, shape.name, mesh_kind, mesh.num_devices, counts,
                   plan.collectives, cfg, shape, tcfg.param_dtype, trace_s,
                   counts["peak_bytes"] / 1e9)
    meta = {"hlo_chars": None, "device": "meta",
            "model_axis": ("sharded" if model_axis(cfg, mesh) > 1
                           else "replicated"),
            "model_rank": share_rank(cfg, mesh),
            "whole_leaves": whole_leaves_record(cfg, mesh, inputs[0]),
            "collectives": collectives_by_op(plan.collectives,
                                             plan.collective_axes),
            "kernels": counts["kernels"]}
    return roof, mem, meta


def whole_leaves_record(cfg: ModelConfig, mesh: MeshConfig, params) -> dict:
    """The leaves the share holds whole though the reference's rules cut
    them over ``model`` (their width does not divide the axis,
    ``sharding.whole_leaves``): their paths, count and bytes in
    ``params`` (the share's), which the peak counts at their whole
    size."""
    tp = model_axis(cfg, mesh)
    paths = sharding.whole_leaves(cfg, tp) if tp > 1 else ()
    held = dict(sharding._leaf_paths(params, ""))
    return {"paths": list(paths), "count": len(paths),
            "bytes": sum(held[p].numel() * held[p].element_size()
                         for p in paths)}


def collectives_by_op(planned, axes) -> dict:
    """{group axes: {op: {"count", "bytes"}}} of (op, operand bytes,
    group size) records and the axes of each one's group (joined by
    ","), the operand bytes summed."""
    out: dict = {}
    for (op, nbytes, _), ax in zip(planned, axes):
        rec = out.setdefault(",".join(ax), {}).setdefault(
            op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += int(nbytes)
    return out


def run_cell(arch, shape_name, mesh_kind, tcfg, out_dir, bucketed=False,
             name_tag="", knobs=None):
    """Trace one cell and write its record; ``knobs`` (the lowering
    knobs set off their defaults: {"attn", "attn_chunk"} under the
    blockwise impl, "remat_policy", "qkv_shard") are added to it."""
    ok, why = cell_is_applicable(arch, shape_name)
    tag = f"{arch}|{shape_name}|{mesh_kind}"
    if not ok:
        print(f"SKIP {tag}: {why}")
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": why}
    try:
        roof, mem_dict, meta = lower_cell(arch, shape_name, mesh_kind,
                                          tcfg, bucketed)
        rec = dataclasses.asdict(roof)
        rec.update({"memory": mem_dict, "ok": True, **meta})
        print(f"OK   {tag}: {roof.row()}  mem={roof.memory_per_device_gb:.2f}GB"
              f"  trace={roof.compile_seconds:.1f}s")
    except Exception as e:              # one cell's fault, recorded
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        print(f"FAIL {tag}: {type(e).__name__}: {e}")
    rec.update(knobs or {})
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}_{shape_name}_{mesh_kind}".replace(".", "_")
    if bucketed:
        fname += "_bucketed"
    if name_tag:
        fname += "_" + name_tag
    with open(os.path.join(out_dir, fname + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--shape", default="train_4k",
                    choices=list(SHAPES) + ["all"])
    ap.add_argument("--mesh", default="single",
                    help="single | multi | both | SHAPE:AXES "
                         "(e.g. 2x4:data,model)")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape) cell")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--bucketed", action="store_true",
                    help="bucketed explicit grad sync (the psum step)")
    ap.add_argument("--bucket-mb", type=float, default=16.0)
    ap.add_argument("--save-hlo", default="")
    ap.add_argument("--attn", default="naive",
                    choices=["naive", "blockwise"],
                    help="blockwise: K6's backward over key chunks")
    ap.add_argument("--attn-chunk", type=int, default=2048)
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots", "none"],
                    help="full recomputes each block, dots keeps its "
                         "products without batch dims, none checkpoints "
                         "nothing")
    ap.add_argument("--no-qkv-shard", action="store_true",
                    help="heads that do not divide the model axis run on "
                         "its cuts of the head dim, the scores summed")
    ap.add_argument("--tag", default="",
                    help="suffix for result filenames")
    args = ap.parse_args(argv)

    if args.save_hlo:
        ap.error("not supported by the PyTorch port: --save-hlo writes "
                 "XLA's HLO; the port lowers no HLO")

    tcfg = train_config(
        microbatches=args.microbatches, remat=not args.no_remat,
        zero1=not args.no_zero1, bucket_mb=args.bucket_mb,
        sequence_parallel=not args.no_seq_parallel)

    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.shape == "all":
        cells = [(args.arch, s) for s in SHAPES]
    else:
        cells = [(args.arch, args.shape)]

    knobs = {}
    if args.attn == "blockwise":
        knobs.update(attn=args.attn, attn_chunk=args.attn_chunk)
    if args.remat_policy != "full":
        knobs["remat_policy"] = args.remat_policy
    if args.no_qkv_shard:
        knobs["qkv_shard"] = False
    results = []
    t0 = time.time()
    # callers in one process (tests) see their own settings again after
    with layers.attention_impl(args.attn, args.attn_chunk), \
            transformer.remat_policy(args.remat_policy), \
            sharding.qkv_sharding(not args.no_qkv_shard):
        for arch, shape_name in cells:
            for mk in meshes:
                results.append(run_cell(arch, shape_name, mk, tcfg, args.out,
                                        args.bucketed, args.tag, knobs))
    n_ok = sum(1 for r in results if r.get("ok"))
    n_skip = sum(1 for r in results if "skipped" in r)
    n_fail = len(results) - n_ok - n_skip
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"in {time.time() - t0:.1f}s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
