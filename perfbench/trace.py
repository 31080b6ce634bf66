"""Reading a traced window: the device's busy time, each kernel's time,
and the idle gaps named by the benchmark's host span they fall in.

The kernel names are the port's (as ``chip_smoke.py``'s
``KERNEL_SYMBOL`` names them): K6's routes and K7's five passes, each a
``__global__`` function the port launches through ``ctypes``. The trace is ``torch.profiler``'s (CUPTI on the card): its
device activities are kernels, copies and sets on one stream, whose
union over the window is the busy time.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

#: the ``__global__`` functions of each port kernel: K6 over its four
#: routes (mma_sync; wgmma; wgmma_tf32's pre-pass and attention;
#: split_kv's split pass and merge), K7's five passes
KERNEL_SYMBOL = {
    "flash_attention": ("flash_attention_kernel", "flash_attention_sm90_kernel",
                        "flash_attention_tf32_split",
                        "flash_attention_sm90_tf32_kernel",
                        "flash_attention_splitkv_kernel",
                        "flash_attention_splitkv_combine"),
    "ssd_scan": ("ssd_scan_cum", "ssd_scan_cb", "ssd_scan_chunk_state",
                 "ssd_scan_state_pass", "ssd_scan_chunk_scan")}

#: device activities that occupy the device
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Traced:
    """A traced window: ``busy_s`` and ``window_s`` (seconds), device
    seconds by kernel or copy name, idle seconds by host span."""
    busy_s: float
    window_s: float
    device_s: dict = field(default_factory=dict)
    idle_s: dict = field(default_factory=dict)

    def kernel_s(self, kernel: str) -> float:
        """The device seconds of a port kernel's functions
        (``KERNEL_SYMBOL``)."""
        sym = re.compile(r"\b(" + "|".join(KERNEL_SYMBOL[kernel]) + r")\b")
        return sum(s for name, s in self.device_s.items() if sym.search(name))

    def breakdown(self) -> dict:
        top = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _kind(e) -> str:
    """The event's activity kind; a kernel where the event cannot say."""
    if not hasattr(e, "activity_type"):
        return "kernel"
    return str(e.activity_type()).lower().rsplit(".", 1)[-1]


def read(prof, window_s: float) -> Traced:
    """The ``Traced`` of a profile whose window is the ``"window"``
    range; ``window_s`` (the host's clock) where the trace lacks it."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    dev, spans, win = [], [], None
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if _kind(e) in _DEVICE_KINDS and not e.is_user_annotation():
                dev.append((start, end, e.name()))
        elif e.is_user_annotation():
            if e.name() == "window":
                win = (start, end)
            else:
                spans.append((start, end, e.name()))
    if win is None:
        win = ((min(s for s, _, _ in dev), max(t for _, t, _ in dev))
               if dev else (0, int(window_s * 1e9)))
    device_s: dict = {}
    for s, t, name in dev:
        device_s[name] = device_s.get(name, 0.0) + (t - s) * 1e-9
    # the union of the device's activities within the window, and the
    # gaps between them, each named by the host span open at its start
    busy, idle = 0, {}
    cursor = win[0]
    spans.sort()
    for s, t, _ in sorted(dev):
        s, t = max(s, win[0]), min(t, win[1])
        if t <= cursor:
            continue
        if s > cursor:
            _name_gap(idle, spans, cursor, s)
        busy += t - max(s, cursor)
        cursor = t
    if win[1] > cursor:
        _name_gap(idle, spans, cursor, win[1])
    return Traced(busy * 1e-9, (win[1] - win[0]) * 1e-9, device_s, idle)


def _name_gap(idle: dict, spans: list, s: int, t: int) -> None:
    """Add the gap [s, t) to the innermost host span open at ``s``."""
    name, width = "outside the spans", None
    for a, b, n in spans:
        if a > s:
            break
        if b > s and (width is None or b - a < width):
            name, width = n, b - a
    idle[name] = idle.get(name, 0.0) + (t - s) * 1e-9
