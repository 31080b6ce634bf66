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
every device). The ``model`` axis is replicated: every rank holds whole
parameters, as the port's mesh steps do, so no tensor-parallel shard is
counted. A train cell runs ``make_train_step`` (forward, backward with
``remat`` as the config says, clip, AdamW; ZeRO-1 cuts ``m`` and ``v``
over the data-parallel ranks) or, with ``bucketed``, the psum step of
``make_bucketed_train_step``, on a ``launch.mesh.PlanMesh`` whose groups
record each collective the step would send (a gradient leaf's or
bucket's all-reduce, the loss's, ZeRO-1's parameter all-gather) with no
process group; on one data-parallel rank it is the plain step with no
mesh. Prefill and decode cells run ``serve/serve_step.py``'s
``prefill_step`` and ``decode_step`` (at the last cache slot); the
port's serving sends no collective.

This is the one entry point of the port that takes no device: ``meta``
computes nothing, so no CUDA device is needed. ``build_cell`` builds the
same step on a real device with seeded inputs, so a trace there can be
set against this one (``chip_smoke.py`` phase 27). The flags that only
steer XLA's lowering in the reference are refused, and there is no
``XLA_FLAGS`` or ``DRYRUN_DEVICES``.

Usage::

  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Union

import numpy as np
import torch

from repro_torch._tree import tree_leaves
from repro_torch.configs.base import (MULTI_POD_MESH, SHAPES, SINGLE_POD_MESH,
                                      MeshConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.configs.registry import (ARCHS, cell_is_applicable,
                                          get_config)
from repro_torch.launch.mesh import PlanMesh, dp_size
from repro_torch.launch.specs import (local_shape, serve_input_specs,
                                      train_input_specs)
from repro_torch.models import init_params
from repro_torch.roofline.analysis import analyze
from repro_torch.roofline.count import OpCounter
from repro_torch.serve.serve_step import decode_step, prefill_step
from repro_torch.train.optimizer import init_adam, zero1_init
from repro_torch.train.train_step import (make_bucketed_train_step,
                                          make_train_step)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: the reference's flags that only steer XLA's lowering, and why the port
#: has none of them
XLA_ONLY = {
    "attn": "--attn blockwise selects an XLA lowering of attention; the "
            "port's attention from an empty cache is always K6",
    "remat_policy": "--remat-policy dots is an XLA checkpoint policy; the "
                    "port checkpoints whole blocks (full) or none",
    "no_qkv_shard": "--no-qkv-shard drops XLA sharding hints the port "
                    "does not have (the model axis is replicated)",
    "no_seq_parallel": "--no-seq-parallel drops an XLA sharding hint the "
                       "port does not have (the model axis is replicated)",
    "save_hlo": "--save-hlo writes XLA's HLO; the port lowers no HLO",
}


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


def _fill(specs: dict, cfg: ModelConfig, seed: int) -> dict:
    """Seeded values of the input ``specs`` on their device (meta specs
    pass through): token ids and labels in the vocab, position ids
    counting from 0, N(0, 1) frames and patches."""
    if next(iter(specs.values())).device.type == "meta":
        return specs
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in specs.items():
        if k == "mrope_positions":
            ids = torch.arange(v.shape[-1], dtype=torch.int32)
            out[k] = ids.expand(v.shape).contiguous().to(v.device)
        elif v.dtype == torch.int32:
            out[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, tuple(v.shape)).astype(np.int32)
            ).to(v.device)
        else:
            out[k] = torch.from_numpy(rng.standard_normal(
                tuple(v.shape), dtype=np.float32)).to(v.device, v.dtype)
    return out


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshConfig,
               tcfg: TrainConfig, bucketed: bool = False, device="meta",
               seed: int = 0):
    """One device's share of a cell: (fn, inputs, plan) where ``fn()``
    runs the step once on ``inputs`` (params, optimizer state or caches,
    the batch), all on ``device`` in ``tcfg.param_dtype``, and ``plan``
    is the ``PlanMesh`` whose ``collectives`` the step records. On
    ``meta`` nothing is drawn; elsewhere params and inputs come from
    ``seed``."""
    dtype = getattr(torch, tcfg.param_dtype)
    params = init_params(cfg, seed, dtype, device)
    plan = PlanMesh(mesh.shape, mesh.axes)
    if shape.kind == "train":
        batch = _fill(train_input_specs(cfg, shape, dtype, device), cfg,
                      seed + 1)
        opt = init_adam(params)
        if bucketed:
            step = make_bucketed_train_step(cfg, tcfg, plan, sync="psum")
        elif dp_size(plan) > 1:
            step = make_train_step(cfg, tcfg, plan)
            if tcfg.zero1:
                opt = zero1_init(opt, plan)
        else:
            step = make_train_step(cfg, tcfg)
        return (lambda: step(params, opt, batch)), (params, opt, batch), plan
    share = local_shape(shape, mesh)
    specs = serve_input_specs(cfg, share, shape.kind, dtype, device)
    caches = specs.pop("caches")
    specs.pop("pos", None)
    batch = _fill(specs, cfg, seed + 1)
    if shape.kind == "prefill":
        def fn():
            with torch.no_grad():
                return prefill_step(params, cfg, batch, caches)
    else:
        extra = {k: v for k, v in batch.items() if k != "tokens"}

        def fn():
            with torch.no_grad():
                return decode_step(params, cfg, batch["tokens"], caches,
                                   share.seq_len - 1, extra=extra or None)
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
    meta = {"hlo_chars": None, "device": "meta", "model_axis": "replicated",
            "kernels": counts["kernels"]}
    return roof, mem, meta


def run_cell(arch, shape_name, mesh_kind, tcfg, out_dir, bucketed=False,
             name_tag=""):
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
                    choices=["naive", "blockwise"])
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots", "none"],
                    help="full checkpoints each block, none nothing")
    ap.add_argument("--no-qkv-shard", action="store_true")
    ap.add_argument("--tag", default="",
                    help="suffix for result filenames")
    args = ap.parse_args(argv)

    refused = {"attn": args.attn == "blockwise",
               "remat_policy": args.remat_policy == "dots",
               "no_qkv_shard": args.no_qkv_shard,
               "no_seq_parallel": args.no_seq_parallel,
               "save_hlo": bool(args.save_hlo)}
    for flag, why in XLA_ONLY.items():
        if refused[flag]:
            ap.error(f"not supported by the PyTorch port: {why}")

    tcfg = TrainConfig(
        microbatches=args.microbatches,
        remat=not args.no_remat and args.remat_policy == "full",
        zero1=not args.no_zero1, grad_bucket_mb=args.bucket_mb,
        param_dtype="bfloat16")

    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.shape == "all":
        cells = [(args.arch, s) for s in SHAPES]
    else:
        cells = [(args.arch, args.shape)]

    results = []
    t0 = time.time()
    for arch, shape_name in cells:
        for mk in meshes:
            results.append(run_cell(arch, shape_name, mk, tcfg, args.out,
                                    args.bucketed, args.tag))
    n_ok = sum(1 for r in results if r.get("ok"))
    n_skip = sum(1 for r in results if "skipped" in r)
    n_fail = len(results) - n_ok - n_skip
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"in {time.time() - t0:.1f}s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
