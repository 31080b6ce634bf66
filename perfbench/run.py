#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch port once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``<cell>`` is a ``workloads`` name in
``BENCHMARK.json``. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` and,
with ``--trace 1``, ``breakdown``); the numbers that decided
``correct`` close standard error. With ``--trace 0`` the metrics are
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
Without a CUDA device, or with fewer than the cell asks for, it exits
non-zero and prints no result.
"""
import os
import sys
import time


def _process_start() -> float:
    """The wall-clock time this process started (``/proc``), so that
    ``setup_s`` counts the interpreter's start too; the time of this
    line where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime "))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
# kernel and extension caches at fixed paths inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "perfbench", ".cache", _sub)
os.environ["USE_FLAX"] = "0"

if __name__ == "__main__":
    from perfbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
