"""device_idle.prefill: the share of the traced window in which no
kernel, copy or set ran on the device (%), in prefill cells. It moves
the cell's tokens per second: an idle device waits for the host."""


def read(run):
    if run.traffic["kind"] != "prefill" or run.traced is None:
        return None
    t = run.traced
    if t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
