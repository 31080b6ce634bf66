"""Hardware constants + α–β cost models.

Two profiles:

* ``PAPER_HW`` — the paper's testbed (Alveo U250, PCIe 3.0 x16, 100 GbE,
  250 MHz fabric clock). Used by the discrete-event simulator to reproduce
  Figs 8–12 and §VI-B.
* ``EXECUTOR_COST`` — the fixed host costs of this package's descriptor
  executor on an NVIDIA H100, measured on the card by ``chip_smoke.py``
  (phase ``executor cost``).

All times in seconds, sizes in bytes, rates in units/second.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PaperHW:
    """Constants from the paper's text (§VI) or fitted to its anchors."""
    clock_hz: float = 250e6                  # ERNIC fabric clock
    line_rate: float = 100e9 / 8             # 100 Gb/s -> bytes/s
    pcie_peak: float = 15.76e9               # PCIe 3.0 x16 usable peak
    pcie_eff: float = 0.825                  # measured 82.5% (=> ~13 GB/s)
    # WQE fetch over PCIe slave bridge (§VI-C): 170 cycles first, 10 after
    wqe_fetch_first: float = 170 * 4e-9      # 680 ns
    wqe_fetch_next: float = 10 * 4e-9        # 40 ns
    # host-memory access latency (Fig 8): 600..964 ns for <= 2048 B
    host_access_base: float = 600e-9
    host_access_2k: float = 964e-9
    # MMIO register ops over PCIe AXI4-Lite ("inherently slow", §VI-C)
    mmio_write: float = 200e-9               # posted doorbell write
    mmio_read: float = 850e-9                # CQ poll read (non-posted RTT)
    sw_poll_overhead: float = 2.3e-6         # host poll loop + syscall path
    wire_prop: float = 250e-9                # cable + MAC one-way
    resp_process: float = 900e-9             # responder engine + dev-mem read
    per_wqe_gap: float = 190e-9              # steady-state pipeline bubble

    @property
    def pcie_rate(self) -> float:
        return self.pcie_peak * self.pcie_eff  # ~13 GB/s

    def host_access_latency(self, nbytes: int) -> float:
        """Fig 8: ~600 ns small, ~964 ns at 2 KB, then bandwidth-limited."""
        if nbytes <= 64:
            return self.host_access_base
        if nbytes <= 2048:
            f = (nbytes - 64) / (2048 - 64)
            return self.host_access_base + f * (self.host_access_2k
                                                - self.host_access_base)
        return self.host_access_2k + (nbytes - 2048) / self.pcie_rate


@dataclass(frozen=True)
class ExecutorCost:
    """Fixed host costs of the port's descriptor executor: one doorbell's
    ``execute_batch`` is the dispatch, a ``host_write`` the QDMA staging
    dispatch, and ``compile_s`` what a call at a (slots, chunk) bucket
    never seen before costs over a warm call (the executor runs eagerly
    and compiles nothing, so this is whatever the card shows).

    The defaults are the H100 profile: the median of three runs of
    ``chip_smoke.py``'s ``executor cost`` phase on an NVIDIA H100 80GB
    HBM3 (``nvidia-smi``: 700.00 W power limit), each run's value the
    median host wall of 64 synchronised one-descriptor ``execute_batch``
    calls (``dispatch_s``: 45.402, 46.430, 83.272 µs) or 16-word
    ``host_write`` calls (``staging_dispatch_s``: 32.904, 33.869,
    53.698 µs), and of eight fresh buckets' first call less a warm call
    (``compile_s``: 5.761, 5.450, 15.505 µs)."""
    compile_s: float = 5.761e-6
    dispatch_s: float = 46.430e-6
    staging_dispatch_s: float = 33.869e-6


@dataclass(frozen=True)
class LCOffload:
    """Lookaside-offload cost constants (paper §IV-C vs host staging).

    The offloaded path RDMA-moves operands/results over the wire once and
    computes on the NIC fabric; the host-staged path additionally crosses
    PCIe twice (QDMA in + out) and computes on the host CPU. ``chunk_bytes``
    is the WQE payload granularity the offload engine batches at.
    """
    # 16x16 MAC systolic array @ 250 MHz fabric clock, 2 flops per MAC —
    # the paper's HLS lookaside matmul block.
    systolic_flops: float = 2 * 16 * 16 * 250e6        # 1.28e11
    # single-socket host GEMM (AVX-ish fp32) the staged baseline runs on
    host_mm_flops: float = 2.5e11
    chunk_bytes: int = 16384


@dataclass(frozen=True)
class StreamingRX:
    """Streaming-compute cost constants (paper §IV-D).

    The RX ring lives in dev_mem: packets land straight off the MAC and
    the parser fires per burst with no host round trip. ``parse_per_pkt_s``
    is the P4-style header-parse pipeline at the 250 MHz fabric clock
    (two cycles per header once the pipe is full); ``status_fifo_s`` the
    on-card status-FIFO push the host later polls for free;
    ``meta_bytes`` one [is_rdma, opcode, dest_qp, class] metadata row.
    """
    slot_bytes: int = 64
    meta_bytes: int = 16
    parse_per_pkt_s: float = 2 * 4e-9
    status_fifo_s: float = 40e-9


PAPER_HW = PaperHW()
EXECUTOR_COST = ExecutorCost()
LC_OFFLOAD = LCOffload()
STREAMING_RX = StreamingRX()


def jain_fairness_index(shares) -> float:
    """Jain's fairness index of per-QP service: (Σx)² / (n·Σx²).
    1.0 = perfectly even service, 1/n = one QP monopolizes the engine —
    the multi-QP scheduler's scorecard (cf. ORCA's µs-scale accounting).
    Empty or all-zero input counts as fair (nothing was contended)."""
    xs = [float(x) for x in shares]
    sq = sum(x * x for x in xs)
    if not xs or sq == 0.0:
        return 1.0
    return sum(xs) ** 2 / (len(xs) * sq)


def ring_all_reduce_bytes(nbytes: int, n: int) -> float:
    """Per-device wire bytes for a ring all-reduce."""
    return 2.0 * (n - 1) / n * nbytes


def all_gather_bytes(nbytes_shard: int, n: int) -> float:
    return (n - 1) * nbytes_shard
