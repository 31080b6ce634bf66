"""k7_roofline.prefill: K7's (``kernels/ssd_scan.py``) share of its
roofline in a prefill (%): the least time the scan of the traced
window's prompts needs, the larger of its operations at 989 TFLOP/s and
its bytes at 3.35 TB/s, over K7's traced device time.

The work is the model's scan of every SSM head, counted once: the share
needs ``1 / n`` of it (its part of the heads), whatever the program
scans. Per chunk of L tokens, C.B over its (i >= j) pairs and their
weighted sums of x for every head, and per token and head the state's
increment and read-out (2 P N each); bytes: x, dt, B and C read once and
y written once, in f32."""
from perfbench import counts


def scan_work(conf: dict, b: int, s: int):
    """(operations, bytes) of one layer's scan of the whole model."""
    di = conf["mamba_expand"] * conf["hidden_size"]
    p, ns, chunk = conf["ssm_head_dim"], conf["mamba_d_state"], \
        conf["ssm_chunk"]
    nh = di // p
    pairs = chunk * (chunk + 1) // 2
    flops = (s // chunk) * pairs * (2 * ns + 2 * p * nh) + s * nh * 4 * p * ns
    nbytes = counts.F32 * (2 * s * nh * p + s * nh + 2 * s * ns)
    return b * flops, b * nbytes


def read(run):
    if run.traffic["kind"] != "prefill" or run.traced is None \
            or run.conf["family"] != "hybrid":
        return None
    k7_s = run.traced.kernel_s("ssd_scan")
    if k7_s <= 0:
        return None
    c = run.counts
    flops, nbytes = scan_work(run.conf, c["batch"], c["prompt_len"])
    need = max(flops / counts.PEAK_BF16_FLOPS, nbytes / counts.PEAK_HBM_BYTES)
    layers = run.conf["num_hidden_layers"]
    return 100.0 * need * layers * c["ops"] / run.share.n / k7_s
