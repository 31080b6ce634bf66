"""The yardstick's arithmetic: the work a cell needs, from the
configuration's published widths and the cell's shapes alone, never from
the program's trace or its own cost formulas, so that it reads the same
whatever later implements the work; and the peaks of one NVIDIA H100
SXM (NVIDIA's data sheet, dense, at its 700 W limit).

Counted once: a product of an (m, k) by a (k, n) matrix is 2 m k n
operations; attention over p keys is 2 (d_qk + d_v) p a head and
query. Each configuration file names its ``family``, which picks the
count. Work the program does twice is not counted.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_HBM_BYTES = 3.35e12        # HBM3 bytes/s
BF16 = 2
F32 = 4


def _w(conf, key, default=None):
    return conf.get("published", {}).get(key, conf.get(key, default))


def attention_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs a causal prompt of ``s`` tokens from position
    0 scores, each query over at most ``window`` keys (0: all)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def keys_at(pos: int, window: int = 0) -> int:
    """Keys a query at position ``pos`` attends to."""
    return pos + 1 if window <= 0 else min(pos + 1, window)


def layer_windows(conf: dict) -> list:
    """Each layer's attention window (0: global)."""
    n = conf["num_hidden_layers"]
    win = conf.get("sliding_window", 0)
    glob = set(conf.get("as_run", {}).get("global_attn_idx", range(n)))
    return [0 if i in glob else win for i in range(n)]


def matmul_params(conf: dict) -> list:
    """Per layer, the weights a token multiplies through in the whole
    model (the routed experts at ``num_experts_per_tok``): a list of
    counts, one a layer, and the head's last."""
    d = conf["hidden_size"]
    fam = conf["family"]
    out = []
    for i in range(conf["num_hidden_layers"]):
        if fam == "moe_mla":
            h = _w(conf, "num_attention_heads")
            dn, dr, dv = (conf["qk_nope_head_dim"], conf["qk_rope_head_dim"],
                          conf["v_head_dim"])
            r = conf["kv_lora_rank"]
            p = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) \
                + h * dv * d
            if i < conf["first_k_dense_replace"]:
                p += 3 * d * conf["intermediate_size"]
            else:
                ff = conf["moe_intermediate_size"]
                p += d * _w(conf, "n_routed_experts") + 3 * d * ff * (
                    conf["num_experts_per_tok"] + conf["n_shared_experts"])
        elif fam == "hybrid":
            hd = conf["head_dim"]
            hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
            di = conf["mamba_expand"] * d
            ns = conf["mamba_d_state"]
            nh = di // conf["ssm_head_dim"]
            p = 2 * d * hq * hd + 2 * d * hkv * hd
            p += d * (2 * di + 2 * ns + nh) + di * d
            p += 3 * d * conf["intermediate_size"]
        else:
            raise KeyError(f"no count for the family {fam!r}")
        out.append(p)
    out.append(d * _w(conf, "vocab_size"))
    return out


def attention_dims(conf: dict) -> tuple:
    """(heads, d_qk, d_v) of a layer's attention in the whole model."""
    if conf["family"] == "moe_mla":
        return (_w(conf, "num_attention_heads"),
                conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"],
                conf["v_head_dim"])
    return conf["num_attention_heads"], conf["head_dim"], conf["head_dim"]


def ssm_readout_flops(conf: dict) -> int:
    """The SSM's read-out of its state a token and layer, C . S."""
    if conf["family"] != "hybrid":
        return 0
    return 2 * conf["mamba_expand"] * conf["hidden_size"] \
        * conf["mamba_d_state"]


def ssm_token_flops(conf: dict) -> int:
    """The SSM's own operations a token and layer, outside the
    projections: the conv taps, the state's decay and update, and the
    read-out."""
    if conf["family"] != "hybrid":
        return 0
    di = conf["mamba_expand"] * conf["hidden_size"]
    ns = conf["mamba_d_state"]
    return 2 * (di + 2 * ns) * conf["mamba_d_conv"] + 4 * di * ns \
        + ssm_readout_flops(conf)


def prefill_flops(conf: dict, batch: int, s: int) -> float:
    """The whole model's operations for ``batch`` prompts of ``s``
    tokens from position 0."""
    h, dqk, dv = attention_dims(conf)
    per_token = 2 * sum(matmul_params(conf)) + conf["num_hidden_layers"] \
        * ssm_token_flops(conf)
    attn = sum(2 * h * (dqk + dv) * attention_pairs(s, w)
               for w in layer_windows(conf))
    return batch * (s * per_token + attn)


def decode_flops(conf: dict, batch: int, pos: int) -> float:
    """The whole model's operations for one token of each of ``batch``
    sequences at position ``pos``."""
    h, dqk, dv = attention_dims(conf)
    per_token = 2 * sum(matmul_params(conf)) + conf["num_hidden_layers"] \
        * ssm_token_flops(conf)
    attn = sum(2 * h * (dqk + dv) * keys_at(pos, w)
               for w in layer_windows(conf))
    return batch * (per_token + attn)
