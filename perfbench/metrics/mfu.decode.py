"""mfu.decode: the whole decode step's share of the chip's bf16 peak
(%): the model's operations for the tokens the traced window generated
(``counts.decode_flops`` at each token's position), divided by the
ranks of the ``model`` axis, over the traced window at 989 TFLOP/s."""
from perfbench import counts


def read(run):
    if run.traffic["kind"] != "decode" or run.traced is None:
        return None
    c = run.counts
    flops = sum(counts.decode_flops(run.conf, c["batch"], c["pos0"] + i)
                for i in range(c["steps"])) / run.share.n
    return 100.0 * flops / (counts.PEAK_BF16_FLOPS * run.traced.window_s)
