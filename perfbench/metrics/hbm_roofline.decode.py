"""hbm_roofline.decode: the decode step's share of the HBM roofline
(%): the bytes each step of the traced window needs, read once at
3.35 TB/s, over the traced window. A step reads the share's weights
(bf16; one row of the embedding) and, per layer, the rank's part of the
keys and values the query can see (a windowed layer's window, a global
one's every position so far), and reads and writes the SSM's conv and
state. Counted from the configuration for the hybrid family."""
from perfbench import counts


def share_weight_bytes(conf: dict, n: int) -> int:
    d = conf["hidden_size"]
    hd, hq, hkv = (conf["head_dim"], conf["num_attention_heads"],
                   conf["num_key_value_heads"])
    di = conf["mamba_expand"] * d
    ns, k = conf["mamba_d_state"], conf["mamba_d_conv"]
    nh = di // conf["ssm_head_dim"]
    per_layer = (2 * d * hq * hd + 2 * d * hkv * hd) // n \
        + d * (2 * di + 2 * ns + nh) + k * (di + 2 * ns) // n + di \
        + di * d // n + 3 * d * conf["intermediate_size"] // n + 4 * d
    return counts.BF16 * (conf["num_hidden_layers"] * per_layer
                          + d * conf["vocab_size"] + 2 * d)


def step_bytes(conf: dict, n: int, batch: int, pos: int) -> int:
    d = conf["hidden_size"]
    di = conf["mamba_expand"] * d
    ns, k = conf["mamba_d_state"], conf["mamba_d_conv"]
    hd, hkv = conf["head_dim"], conf["num_key_value_heads"]
    nh = di // conf["ssm_head_dim"]
    cache = 0
    for w in counts.layer_windows(conf):
        cache += counts.BF16 * counts.keys_at(pos, w) * 2 * hkv * hd // n
        cache += 2 * (counts.F32 * nh * (hd // n) * ns
                      + counts.BF16 * (k - 1) * (di + 2 * ns) // n)
    return share_weight_bytes(conf, n) + batch * cache


def read(run):
    if run.traffic["kind"] != "decode" or run.traced is None \
            or run.conf["family"] != "hybrid":
        return None
    c = run.counts
    need = sum(step_bytes(run.conf, run.share.n, c["batch"], c["pos0"] + i)
               for i in range(c["steps"]))
    return 100.0 * need / counts.PEAK_HBM_BYTES / run.traced.window_s
