"""Input specs and partition specs for every dry-run cell.

The port of ``repro/launch/specs.py``. An input spec is an empty tensor
on the ``meta`` device (``sds``): the shape and dtype of a model input,
with no memory behind it (the paper's "hardware simulation without
hardware" posture). ``train_input_specs`` and ``serve_input_specs`` give
the reference's keys, shapes and dtypes (bf16 stand-ins; the caches are
the port's ``init_caches`` on ``meta``).

The partition functions are pure functions over a mesh *description*, a
``configs.base.MeshConfig`` (axis names and sizes): no process group is
needed or made, so a 512-device mesh is described without 512 ranks.
They return specs in the convention of ``models/sharding.py``: a tuple
with one entry per dimension, ``None`` for a replicated one, an axis
name, or a tuple of axis names (the entries of the reference's
``PartitionSpec``). The reference's ``named`` (a ``NamedSharding`` tree)
has no counterpart: a rank holds its cut instead
(``models.sharding.shard_tree``, ``init_params(tp_size=)``,
``init_caches(tp_size=)``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.models.sharding import _set
from repro_torch.models.transformer import init_caches

DP_AXES = ("pod", "data")


def sds(shape, dtype, device="meta") -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype``: an empty tensor on
    ``device`` (``meta``: no memory)."""
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def axis_sizes(mesh: MeshConfig) -> Dict[str, int]:
    return dict(zip(mesh.axes, mesh.shape))


def batch_partition(mesh: MeshConfig, global_batch: int):
    """Batch-dim sharding: over (pod, data) when divisible, else None."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in DP_AXES if a in sizes)
    size = 1
    for a in axes:
        size *= sizes[a]
    if axes and global_batch % size == 0:
        return axes if len(axes) > 1 else axes[0]
    return None


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                      dtype=torch.bfloat16, device="meta") -> Dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": sds((b, s), torch.int32, device),
             "labels": sds((b, s), torch.int32, device)}
    if cfg.mrope:
        specs["mrope_positions"] = sds((3, b, s), torch.int32, device)
        specs["patch_embeds"] = sds(
            (b, s // cfg.vision_patches_ratio, cfg.d_model), dtype, device)
    if cfg.enc_dec:
        specs["enc_embeds"] = sds(
            (b, s // cfg.encoder_seq_ratio, cfg.d_model), dtype, device)
    return specs


def serve_input_specs(cfg: ModelConfig, shape: ShapeConfig, kind: str,
                      dtype=torch.bfloat16, device="meta",
                      tp_size: int = 1) -> Dict:
    """kind: 'prefill' (tokens = full prompt) or 'decode' (one token,
    caches at seq_len depth). ``pos`` is a 0-d int32 stand-in, as the
    reference's; the port's ``decode_step`` takes it as a host int.
    ``tp_size``: the caches are a rank's cut over a ``model`` axis of
    that size (``init_caches(tp_size=)``, the cut of
    ``cache_partition_specs``)."""
    b, s = shape.global_batch, shape.seq_len
    if kind == "prefill":
        specs = {"tokens": sds((b, s), torch.int32, device)}
        toks_s = s
    else:
        specs = {"tokens": sds((b, 1), torch.int32, device),
                 "pos": sds((), torch.int32, device)}
        toks_s = 1
    if cfg.mrope:
        specs["mrope_positions"] = sds((3, b, toks_s), torch.int32, device)
        if kind == "prefill":
            specs["patch_embeds"] = sds(
                (b, s // cfg.vision_patches_ratio, cfg.d_model), dtype,
                device)
    if cfg.enc_dec:
        specs["enc_embeds"] = sds(
            (b, s // cfg.encoder_seq_ratio, cfg.d_model), dtype, device)
    specs["caches"] = init_caches(cfg, b, s, dtype, device=device,
                                  tp_size=tp_size)
    return specs


def batch_spec_tree(cfg: ModelConfig, specs: Dict, mesh: MeshConfig,
                    global_batch: int) -> Dict:
    """Partition specs for the input dict (caches included)."""
    bp = batch_partition(mesh, global_batch)
    out = {}
    for k, v in specs.items():
        if k == "caches":
            out[k] = cache_partition_specs(v, mesh, global_batch)
        elif k == "pos":
            out[k] = ()
        elif k == "mrope_positions":
            out[k] = (None, bp, None)
        elif k in ("patch_embeds", "enc_embeds"):
            out[k] = (bp, None, None)
        else:                          # tokens / labels / positions (B, S)
            out[k] = (bp, None)
    return out


# base (unstacked) ranks per leaf kind; stacked leaves gain a layer dim
_BASE_RANK = {"k": 4, "v": 4, "c_kv": 3, "k_rope": 3, "conv": 3, "ssm": 4}


def cache_partition_specs(caches, mesh: MeshConfig,
                          global_batch: int) -> Dict:
    """Cache specs. Batch over dp when divisible; otherwise the cache
    SEQUENCE dim is dp-sharded (long_500k, B=1). Feature dims over
    'model' where the per-arch dims divide (head_dim / latent /
    channels)."""
    sizes = axis_sizes(mesh)
    bp = batch_partition(mesh, global_batch)
    dp = tuple(a for a in DP_AXES if a in sizes)
    # one axis by its name, as a PartitionSpec writes a 1-tuple
    seq_p = None if bp is not None or not dp else (
        dp if len(dp) > 1 else dp[0])
    tp = "model" if "model" in sizes else None
    tp_size = sizes[tp] if tp else 1

    def leaf_spec(name: str, x) -> tuple:
        dims = tuple(x.shape)
        if len(dims) == 0 or name == "pos":
            return ()
        base = _BASE_RANK.get(name)
        if base is None:
            return (None,) * len(dims)
        off = len(dims) - base         # 1 when stacked, else 0

        def tp_if(axis_idx):
            i = axis_idx + off
            return tp if tp and dims[i] % tp_size == 0 else None

        if name in ("k", "v"):         # (B, S, Hkv, hd)
            body = (bp, seq_p, None, tp_if(3))
        elif name in ("c_kv", "k_rope"):  # (B, S, r)
            body = (bp, seq_p, tp_if(2))
        elif name == "conv":           # (B, K-1, C)
            body = (bp, None, tp_if(2))
        else:                          # ssm: (B, nh, hd, N)
            body = (bp, None, tp_if(2), None)
        return (None,) * off + body

    out: Dict = {}

    def walk(tree, keys):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, keys + [str(k)])
        else:
            _set(out, keys, leaf_spec(keys[-1], tree))

    walk(caches, [])
    return out


def sanitize_specs(specs, shapes, mesh: MeshConfig):
    """Drop spec entries whose dim is not divisible by the mesh-axis
    extent (ragged fused projections, odd head counts, ...). ``specs``
    and ``shapes`` are trees of one structure: spec tuples, and tensors
    (or anything with a ``shape``)."""
    sizes = axis_sizes(mesh)

    def fix(spec: tuple, dims) -> tuple:
        clean = []
        for i, entry in enumerate(spec):
            if entry is None:
                clean.append(None)
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            extent = 1
            for a in names:
                extent *= sizes.get(a, 1)
            dim = dims[i] if i < len(dims) else 1
            clean.append(entry if dim % extent == 0 else None)
        return tuple(clean)

    if isinstance(specs, dict):
        return {k: sanitize_specs(v, shapes[k], mesh)
                for k, v in specs.items()}
    return fix(specs, tuple(shapes.shape))


def local_shape(shape: ShapeConfig, mesh: MeshConfig) -> ShapeConfig:
    """One device's share of ``shape``: the batch split over (pod, data)
    where ``batch_partition`` allows, else whole."""
    if batch_partition(mesh, shape.global_batch) is None:
        return shape
    n = 1
    for a, size in axis_sizes(mesh).items():
        if a in DP_AXES:
            n *= size
    return ShapeConfig(shape.name, shape.seq_len, shape.global_batch // n,
                       shape.kind)
