"""k6_roofline.prefill: K6's (``kernels/flash_attention.py``) share of
its roofline in a prefill (%): the least time the calls of the traced
window need, each the larger of its operations at 989 TFLOP/s and its
bytes at 3.35 TB/s, over K6's traced device time.

A call is one layer's attention from an empty cache over the share's
heads and rows. Operations: 2 (d_qk + d_v) for each (query, key) pair
the causal mask, and a layer's window, leave; bytes: q, k, v read once
and the output written once, in bf16, for the keys the rows can see."""
from perfbench import counts


def _call(conf: dict, n: int, rank: int, b: int, s: int, window: int):
    """(operations, bytes) of one layer's call."""
    h, dqk, dv = counts.attention_dims(conf)
    if conf["family"] == "moe_mla":
        hq = hkv = conf["num_attention_heads"]          # the share's heads
        r0, r1 = 0, s
    else:
        hq, hkv = h, conf["num_key_value_heads"]        # every head,
        r0, r1 = rank * s // n, (rank + 1) * s // n     # the rank's rows
    pairs = sum(counts.keys_at(p, window) for p in range(r0, r1))
    k0 = max(0, r0 - window + 1) if window > 0 else 0
    flops = 2 * b * hq * (dqk + dv) * pairs
    nbytes = counts.BF16 * b * ((r1 - r0) * hq * (dqk + dv)
                                + (r1 - k0) * hkv * (dqk + dv))
    return flops, nbytes


def read(run):
    if run.traffic["kind"] != "prefill" or run.traced is None:
        return None
    k6_s = run.traced.kernel_s("flash_attention")
    if k6_s <= 0:
        return None
    c, sh = run.counts, run.share
    need = 0.0
    for w in counts.layer_windows(run.conf):
        flops, nbytes = _call(run.conf, sh.n, sh.rank, c["batch"],
                              c["prompt_len"], w)
        need += max(flops / counts.PEAK_BF16_FLOPS,
                    nbytes / counts.PEAK_HBM_BYTES)
    return 100.0 * need * c["ops"] / k6_s
