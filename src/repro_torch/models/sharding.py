"""Sharding rules: logical roles -> per-dimension mesh axis names.

The port of ``repro/models/sharding.py``'s parameter rules, as pure
functions: a spec is a tuple with one entry per dimension, ``None`` for
a replicated dimension, an axis name, or a tuple of axis names (the
entries of the reference's ``PartitionSpec``). Specs are derived from
leaf *paths* by role rules (Megatron-style TP):

  column-parallel (out dim on 'model'):  wq wk wv w_gate w_up lm_head
                                         w_uk w_uv w_qa w_qb embed(d dim)
  row-parallel    (in dim on 'model'):   wo w_down out_proj
  expert-parallel (E dim on 'model'):    experts/* 3-D weights
  replicated:                            norms, scalars, small biases

The port replicates the ``model`` axis: ZeRO-1 (``train.optimizer``)
reads these specs to find each leaf's free dimension for the
data-parallel shard. The reference's XLA layout hints (``shard``,
``shard_residual``, ``shard_activation_tp``, ``shard_attention_*``,
``attention_seq_mode``) have no PyTorch counterpart and are not ported.
"""
from __future__ import annotations

# leaf-name -> rule
_COLUMN = {"wq", "wk", "wv", "w_gate", "w_up", "lm_head", "w_uk", "w_uv",
           "w_qa", "w_qb", "w_kr", "in_proj", "conv_w", "b_q", "b_k", "b_v",
           "b_in"}
_ROW = {"wo", "w_down", "out_proj"}
_EMBED = {"embed", "pos_embed"}
_REPLICATED_SUFFIX = {"scale", "bias", "a_log", "d_skip", "dt_bias", "b_o",
                      "b_down", "router", "w_dkv", "norm"}


def spec_for_leaf(path: str, ndim: int, scanned: bool) -> tuple:
    """The spec of a parameter leaf. ``scanned`` leaves carry a leading
    layer dim (always unsharded)."""
    name = path.split("/")[-1].lower()
    body = _body_spec(path, name, ndim - (1 if scanned else 0))
    if scanned:
        return (None,) + body
    return body


def _body_spec(path: str, name: str, ndim: int) -> tuple:
    if "experts" in path and ndim == 3:
        # (E, d_in, d_out): expert-parallel over 'model'
        return ("model", None, None)
    if name in _EMBED:
        # (vocab, d): vocab-parallel; the (tied) LM head stays
        # column-parallel.
        return ("model", None)
    if name in _ROW:
        return ("model",) + (None,) * (ndim - 1)
    if name in _COLUMN:
        if ndim == 1:                    # column bias
            return ("model",)
        return (None,) * (ndim - 1) + ("model",)
    return (None,) * ndim                # norms, scalars: replicated


def param_specs(params, scanned_prefixes=("layers", "enc_layers",
                                          "dec_layers")) -> dict:
    """The full spec tree of a param tree (nested dicts of tensors)."""
    out = {}
    for path, leaf in _leaf_paths(params, ""):
        scanned = any(path.startswith(p + "/") or f"/{p}/" in path
                      for p in scanned_prefixes)
        _set(out, path.split("/"), spec_for_leaf(path, leaf.ndim, scanned))
    return out


def _leaf_paths(tree, prefix: str):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}/{k}" if prefix
                                   else str(k))
    else:
        yield prefix, tree


def _set(d: dict, keys, val):
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = val
