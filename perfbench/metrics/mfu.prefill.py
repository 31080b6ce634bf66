"""mfu.prefill: the whole prefill step's share of the chip's bf16 peak
(%): the model's operations for the prompts the traced window completed
(``counts.prefill_flops``, the published model whole), divided by the
ranks of the ``model`` axis that share every layer, over the traced
window at 989 TFLOP/s."""
from perfbench import counts


def read(run):
    if run.traffic["kind"] != "prefill" or run.traced is None:
        return None
    c = run.counts
    flops = counts.prefill_flops(run.conf, c["batch"], c["prompt_len"]) \
        * c["ops"] / run.share.n
    return 100.0 * flops / (counts.PEAK_BF16_FLOPS * run.traced.window_s)
