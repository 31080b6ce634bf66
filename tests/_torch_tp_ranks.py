"""Rank programs of ``tests/test_torch_tp.py`` (and of the MoE, enc-dec
and SSM files beside it): the port's ``model`` axis as gloo ranks on the
CPU (``launch.mesh.run_peers``), one spawn a mesh.

Each rank takes the JAX package's whole weights (numpy leaves, carried
over by ``params_from_jax``) and cuts its share with
``sharding.shard_tree``; every case runs on the global batch and returns
host arrays for the test to gather over the model ranks and hold
against the JAX package.
"""
import dataclasses

import numpy as np
import torch

from _torch_ranks import _np_tree, _one_thread
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_mesh, model_rank, model_size
from repro_torch.models import params_from_jax, sharding
from repro_torch.models.transformer import forward, init_caches

#: serving traffic: prompt rows, decode steps, cache depth
PROMPT, DECODE, MAX_SEQ = 12, 4, 16


def tp_configs():
    """name -> the port's config: ``tiny`` (4 q heads over 2 KV heads of
    16: heads at a model axis of 2, rows at 4), ``tiny-h8`` (8 q heads
    over 4 KV heads of 8: heads at 2 and 4) and ``tiny-vl`` (the VLM
    family: M-RoPE, QKV bias and patch embeddings over ``tiny``'s
    heads)."""
    tiny = get_config("tiny")
    return {"tiny": tiny,
            "tiny-h8": dataclasses.replace(tiny, name="tiny-h8",
                                           num_heads=8, num_kv_heads=4),
            "tiny-vl": dataclasses.replace(
                tiny, name="tiny-vl", family="vlm", mrope=True,
                mrope_sections=(2, 3, 3), qkv_bias=True, qk_norm=False,
                vision_patches_ratio=4)}


def moe_configs():
    """name -> the port's config of ``tests/test_torch_tp_moe.py``:
    ``tiny-moe`` (the registry's: 4 experts top-2 over ``tiny``'s GQA
    heads, which divide a model axis of 2 and run by rows at 4),
    ``tiny-mla`` (``tiny`` with MLA in place of GQA and a dense FFN; its
    18-wide latent is cut at 2 and whole at 4, its 8 rope dims cut at
    both) and ``tiny-ds`` (deepseek-v2-lite's structure: a dense first
    block, MLA, 8 routed experts top-3 and 2 shared, 3 layers)."""
    from repro_torch.configs.base import MLAConfig, MoEConfig
    return {name: dataclasses.replace(get_config("tiny"), name=name,
                                      **moe_fields(name, MLAConfig,
                                                   MoEConfig))
            for name in ("tiny-moe", "tiny-mla", "tiny-ds")}


def moe_fields(name, mla_cls, moe_cls) -> dict:
    """The fields ``moe_configs`` sets over ``tiny``, built with either
    package's ``MLAConfig`` and ``MoEConfig``."""
    if name == "tiny-moe":
        return dict(family="moe", qk_norm=False, moe=moe_cls(
            num_experts=4, top_k=2, expert_d_ff=64))
    if name == "tiny-mla":
        return dict(qk_norm=False, mla=mla_cls(
            kv_lora_rank=18, q_lora_rank=0, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16))
    return dict(family="moe", num_layers=3, qk_norm=False, mla=mla_cls(
        kv_lora_rank=24, q_lora_rank=0, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16), moe=moe_cls(
        num_experts=8, num_shared_experts=2, top_k=3, expert_d_ff=32,
        shared_d_ff=64, first_dense_layers=1, dense_d_ff=128))


def encdec_configs():
    """name -> the port's config of ``tests/test_torch_tp_encdec.py``,
    seamless-m4t's smoke structure (2 encoder and 2 decoder layers, 16
    dims a head): ``tiny-encdec`` (4 q heads over 4 KV heads, as
    seamless's 16 over 16: heads at a model axis of 2 and 4) and
    ``tiny-encdec-gqa`` (6 over 2: heads at 2, rows at 4, every head
    where the frames do not divide the axis)."""
    base = get_config("seamless-m4t-large-v2-smoke")
    return {name: dataclasses.replace(base, name=name, **encdec_fields(name))
            for name in ("tiny-encdec", "tiny-encdec-gqa")}


def encdec_fields(name) -> dict:
    return (dict(num_heads=4, num_kv_heads=4) if name == "tiny-encdec"
            else dict(num_heads=6, num_kv_heads=2))


def ssm_configs():
    """name -> the port's config of ``tests/test_torch_tp_ssm.py``:
    ``tiny-ssm`` (the registry's: 8 heads of 16, head-parallel at a model
    axis of 2 and 4, every leaf cut), ``tiny-ssm-odd`` (d_model 80 and
    d_state 17: 10 heads, head-parallel at 2, every head on every rank
    at 4, where the conv's 194 channels stay whole and ``out_proj``'s
    40-row cut straddles the heads) and ``tiny-hybrid`` (hymba-1.5b's
    smoke structure at d_model 80: 5 q heads over 1 KV head, rows at 2
    and 4, 3 layers whose middle one has a window of 8; 10 SSM heads,
    every head on every rank at 4, where ``in_proj``'s 362 columns stay
    whole)."""
    return {name: ssm_config(name, get_config)
            for name in ("tiny-ssm", "tiny-ssm-odd", "tiny-hybrid")}


def ssm_config(name, get):
    """``ssm_configs()[name]`` built from either package's registry
    (``get``, its ``get_config``)."""
    base = get("hymba-1.5b-smoke" if name == "tiny-hybrid" else "tiny-ssm")
    return dataclasses.replace(base, name=name, **ssm_fields(name, base))


def ssm_fields(name, base) -> dict:
    if name == "tiny-ssm":
        return {}
    if name == "tiny-ssm-odd":
        return dict(d_model=80,
                    ssm=dataclasses.replace(base.ssm, d_state=17))
    return dict(d_model=80, num_heads=5, num_kv_heads=1, num_layers=3,
                sliding_window=8)


def configs(kind: str) -> dict:
    """The configs of a test file: ``tp_configs()`` for ``"dense"``,
    ``moe_configs()`` for ``"moe"``, ``encdec_configs()`` for
    ``"encdec"``, ``ssm_configs()`` for ``"ssm"``."""
    return {"dense": tp_configs, "moe": moe_configs,
            "encdec": encdec_configs, "ssm": ssm_configs}[kind]()


def tcfg(sp: bool, zero1: bool = False, microbatches: int = 1
         ) -> TrainConfig:
    return TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=20,
                       remat=False, zero1=zero1, sequence_parallel=sp,
                       microbatches=microbatches)


def _batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _serve(cfg, params, prompt, tp):
    """Prefill of the first PROMPT of ``prompt``'s PROMPT + DECODE tokens
    (M-RoPE ids and patches with them for a VLM; an enc-dec model's
    frames with the prefill and every decode step), then DECODE steps on
    the tokens after it: each step's logits (this rank's vocab cut), and
    the cache leaves' shapes by path."""
    from repro_torch.serve.serve_step import decode_step, prefill_step
    full = _batch(prompt)
    toks = full["tokens"]
    caches = init_caches(cfg, toks.shape[0], MAX_SEQ, torch.float32,
                         "cpu", tp_size=tp.size)
    first = dict(full, tokens=toks[:, :PROMPT])
    if cfg.mrope:
        first["mrope_positions"] = full["mrope_positions"][..., :PROMPT]
    outs = []
    with torch.no_grad():
        lg, caches = prefill_step(params, cfg, first, caches, tp=tp)
        outs.append(lg.numpy().copy())
        for pos in range(PROMPT, PROMPT + DECODE):
            extra = ({"mrope_positions":
                      full["mrope_positions"][..., pos:pos + 1]}
                     if cfg.mrope else
                     {"enc_embeds": full["enc_embeds"]} if cfg.enc_dec
                     else None)
            lg, caches = decode_step(params, cfg, toks[:, pos:pos + 1],
                                     caches, pos, extra=extra, tp=tp)
            outs.append(lg.numpy().copy())
    shapes = {p: tuple(v.shape)
              for p, v in sharding._leaf_paths(caches["scan"], "")}
    return outs, shapes


def tp_cases(rank, shape, np_params, batches, prompts, kind="dense"):
    """One rank of a ``shape`` ("data", "model") mesh. For each config
    (``np_params``, ``batches`` and ``prompts`` keyed by its name) and
    sequence parallelism off and on: the forward's logits on the global
    batch, the loss and the whole gradients (``_ModelAxis.grads`` over
    whole parameters), one ``make_train_step(mesh)`` step with and
    without ZeRO-1 on this rank's cut; and, once a config, prefill and
    DECODE decode steps. ``kind`` names the configs (``configs``); for
    ``"moe"`` also a plain step in two microbatches and a psum step
    (``make_bucketed_train_step``), each without ZeRO-1. Returns host
    data keyed by (config, sp, what) and the rank's coordinates."""
    _one_thread()
    from repro_torch.train import init_adam, zero1_init
    from repro_torch.train.train_step import (_ModelAxis,
                                              make_bucketed_train_step,
                                              make_train_step)
    mesh = make_mesh(shape, ("data", "model"))
    n, r = model_size(mesh), model_rank(mesh)
    out = {"coords": list(mesh.get_coordinate())}
    for name, cfg in configs(kind).items():
        whole = params_from_jax(np_params[name], device="cpu")
        cut = params_from_jax(np_params[name], device="cpu", tp_rank=r,
                              tp_size=n)
        batch = _batch(batches[name])
        for sp in (False, True):
            tp = sharding.tensor_parallel(cfg, mesh, sp)
            with torch.no_grad():
                logits, _, _ = forward(cut, cfg, batch, tp=tp)
            out[name, sp, "logits"] = logits.numpy()
            model = _ModelAxis(cfg, tcfg(sp), mesh)
            loss, grads = model.grads(whole, batch, tcfg(sp))
            out[name, sp, "loss"] = float(loss)
            out[name, sp, "grads"] = _np_tree(grads)
            out[name, sp, "forward_collectives"] = dict(model.issued())
            steps = [(f"step zero1={z}", make_train_step(cfg, tcfg(sp, z),
                                                          mesh), z)
                     for z in (False, True)]
            if kind == "moe":
                steps += [("step mb=2", make_train_step(
                    cfg, tcfg(sp, microbatches=2), mesh), False),
                          ("psum", make_bucketed_train_step(
                              cfg, tcfg(sp), mesh, sync="psum"), False)]
            for key, step, zero1 in steps:
                step.keep_grads = True
                opt = init_adam(cut)
                if zero1:
                    opt = zero1_init(opt, mesh)
                loss, p, o = step(cut, opt, batch)[:3]
                out[name, sp, key] = {
                    "loss": float(loss), "params": _np_tree(p),
                    "grads": _np_tree(step.last_grads),
                    "m_shapes": [tuple(t.shape) for t in _leaves(o.m)],
                    "norm": float(step.grad_norm),
                    "model_collectives": dict(step.model_collectives)}
        tp = sharding.tensor_parallel(cfg, mesh, False)
        out[name, "serve"] = _serve(cfg, cut, prompts[name], tp)
    return out


def _leaves(tree):
    from repro_torch._tree import tree_leaves
    return tree_leaves(tree)


#: ``tests/test_torch_tp_knobs.py``'s runs: (config, mesh shape, the
#: knobs). ``ds-h4``: deepseek-v2-lite-16b-smoke with 8 routed experts,
#: so that every leaf but MLA's 4 heads divides a model axis of 8; ``tiny``
#: (4 q heads over 2 KV heads of 16) at 4, where its KV heads do not
#: divide the axis and its head dim does
KNOB_MESHES = {"ds-h4": (1, 8), "tiny": (2, 4)}
#: keys a chunk of the blockwise runs, under the tests' 16 rows
KNOB_CHUNK = 4
#: the knob runs' serving traffic: prompt rows (dividing 8), decode steps
KNOB_PROMPT, KNOB_DECODE, KNOB_MAX_SEQ = 16, 2, 24


def knob_configs(get=get_config) -> dict:
    """name -> config of ``KNOB_MESHES``, from either package's registry
    (``get``, its ``get_config``)."""
    ds = get("deepseek-v2-lite-16b-smoke")
    return {"ds-h4": dataclasses.replace(
                ds, name="ds-h4", moe=dataclasses.replace(ds.moe,
                                                          num_experts=8)),
            "tiny": get("tiny")}


def _knob_serve(cfg, params, prompt, tp):
    """Prefill of KNOB_PROMPT rows, then KNOB_DECODE decode steps: each
    step's logits (this rank's vocab cut)."""
    from repro_torch.serve.serve_step import decode_step, prefill_step
    toks = torch.from_numpy(prompt["tokens"])
    caches = init_caches(cfg, toks.shape[0], KNOB_MAX_SEQ, torch.float32,
                         "cpu", tp_size=tp.size)
    outs = []
    with torch.no_grad():
        lg, caches = prefill_step(params, cfg, {"tokens":
                                                toks[:, :KNOB_PROMPT]},
                                  caches, tp=tp)
        outs.append(lg.numpy().copy())
        for pos in range(KNOB_PROMPT, KNOB_PROMPT + KNOB_DECODE):
            lg, caches = decode_step(params, cfg, toks[:, pos:pos + 1],
                                     caches, pos, tp=tp)
            outs.append(lg.numpy().copy())
    return outs


def knob_cases(rank, np_params, batches, prompts):
    """One rank of each of ``KNOB_MESHES``' (data, model) meshes, made in
    turn over the same 8 ranks. ``ds-h4`` (MLA's heads not dividing the
    axis) with ``qkv_sharding`` on ("rows": K6 over the rank's rows) and
    off ("hd"), ``tiny`` with it off under the naive and the blockwise
    impl (at ``KNOB_CHUNK``): the forward's logits on the global batch,
    the loss and the whole gradients (remat under the ``dots`` policy,
    sequence parallelism off and on), the model group's collectives of
    that step, and prefill then decode. Returns host data keyed by
    (config, knob, what) and each mesh's coordinates."""
    _one_thread()
    from repro_torch.models import layers, transformer
    from repro_torch.train.train_step import _ModelAxis
    out = {}
    for name, cfg in knob_configs().items():
        mesh = make_mesh(KNOB_MESHES[name], ("data", "model"))
        n, r = model_size(mesh), model_rank(mesh)
        out[name, "coords"] = list(mesh.get_coordinate())
        whole = params_from_jax(np_params[name], device="cpu")
        cut = params_from_jax(np_params[name], device="cpu", tp_rank=r,
                              tp_size=n)
        batch = _batch(batches[name])
        knobs = ([("rows", True, "naive"), ("hd", False, "naive")]
                 if name == "ds-h4" else
                 [("hd", False, "naive"), ("hd blockwise", False,
                                           "blockwise")])
        for knob, qkv, impl in knobs:
            with sharding.qkv_sharding(qkv), \
                    layers.attention_impl(impl, KNOB_CHUNK), \
                    transformer.remat_policy("dots"):
                tp = sharding.tensor_parallel(cfg, mesh, False)
                with torch.no_grad():
                    logits, _, _ = forward(cut, cfg, batch, tp=tp)
                out[name, knob, "logits"] = logits.numpy()
                for sp in (False, True):
                    t = dataclasses.replace(tcfg(sp), remat=True)
                    model = _ModelAxis(cfg, t, mesh)
                    loss, grads = model.grads(whole, batch, t)
                    out[name, knob, sp, "loss"] = float(loss)
                    out[name, knob, sp, "grads"] = _np_tree(grads)
                    out[name, knob, sp, "collectives"] = dict(model.issued())
                out[name, knob, "serve"] = _knob_serve(
                    cfg, cut, prompts[name],
                    sharding.tensor_parallel(cfg, mesh, False))
    return out


#: ``tests/test_torch_tp_whole.py``'s runs: mesh shape -> the configs cut
#: over its model axis, none of whose axes divides every leaf
WHOLE_MESHES = {(2, 3): ("train-100m-l2", "deepseek-v2-lite-16b-smoke",
                         "tiny-ssm", "seamless-m4t-large-v2-smoke",
                         "hymba-1.5b-smoke"),
                (1, 8): ("tiny-moe", "deepseek-v2-lite-16b-smoke")}
#: the config whose ZeRO-1 step runs on the data x model mesh
WHOLE_STEP = "train-100m-l2"


def whole_config(name, get=get_config):
    """A config of ``WHOLE_MESHES`` from either package's registry
    (``get``, its ``get_config``): ``train-100m-l2`` is train-100m's
    widths at two layers and a vocab of 512 (whole at 3, as its 32000
    is), the rest the registry's."""
    if name == "train-100m-l2":
        return dataclasses.replace(get("train-100m"), name=name,
                                   num_layers=2, vocab_size=512)
    return get(name)


def whole_cases(rank, shape, np_params, batches, prompts):
    """One rank of a ``shape`` ("data", "model") mesh of
    ``WHOLE_MESHES``. For each of its configs, on data row 0: the
    forward's logits on the global batch (this rank's vocab cut, or the
    whole vocab where the axis leaves it whole), the loss and the whole
    gradients (``_ModelAxis.grads`` over whole parameters), each with
    sequence parallelism off and on, and prefill then DECODE decode
    steps; on a mesh with a data axis, every rank, for ``WHOLE_STEP``:
    one ``make_train_step(mesh)`` step under ZeRO-1 and sequence
    parallelism on this rank's cut. Returns host data keyed by (config, sp, what)
    and the rank's coordinates."""
    _one_thread()
    from repro_torch.train import init_adam, zero1_init
    from repro_torch.train.train_step import _ModelAxis, make_train_step
    mesh = make_mesh(shape, ("data", "model"))
    n, r = model_size(mesh), model_rank(mesh)
    coords = list(mesh.get_coordinate())
    out = {"coords": coords}
    for name in WHOLE_MESHES[shape]:
        cfg = whole_config(name)
        whole = params_from_jax(np_params[name], device="cpu")
        cut = params_from_jax(np_params[name], device="cpu", tp_rank=r,
                              tp_size=n)
        batch = _batch(batches[name])
        if coords[0] == 0:
            for sp in (False, True):
                tp = sharding.tensor_parallel(cfg, mesh, sp)
                with torch.no_grad():
                    logits, _, _ = forward(cut, cfg, batch, tp=tp)
                out[name, sp, "logits"] = logits.numpy()
                model = _ModelAxis(cfg, tcfg(sp), mesh)
                loss, grads = model.grads(whole, batch, tcfg(sp))
                out[name, sp, "loss"] = float(loss)
                out[name, sp, "grads"] = _np_tree(grads)
            tp = sharding.tensor_parallel(cfg, mesh, False)
            out[name, "serve"] = _serve(cfg, cut, prompts[name], tp)
        if shape[0] > 1 and name == WHOLE_STEP:
            step = make_train_step(cfg, tcfg(True, True), mesh)
            step.keep_grads = True
            opt = zero1_init(init_adam(cut), mesh)
            loss, p, o = step(cut, opt, batch)[:3]
            out[name, True, "step zero1=True"] = {
                "loss": float(loss), "params": _np_tree(p),
                "grads": _np_tree(step.last_grads),
                "m_shapes": [tuple(t.shape) for t in _leaves(o.m)]}
    return out
