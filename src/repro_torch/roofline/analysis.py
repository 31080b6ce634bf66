"""Roofline analysis of a dry-run cell, against an NVIDIA H100.

The port of ``repro/roofline/analysis.py``. Three terms per (arch x
shape x mesh), every quantity per device:

    compute    = flops_per_device      / peak FLOP/s of the param dtype
    memory     = bytes_per_device      / HBM bytes/s
    collective = coll_bytes_per_device / link bytes/s

The FLOPs and bytes are the totals of ``roofline.count.OpCounter`` over
one traced step (the reference reads XLA's ``cost_analysis`` and the
compiled HLO); the collectives are the ones the step plans
(``launch.mesh.PlanMesh``), with the reference's ring wire factors.

The hardware is ``H100``: the data sheet's dense peaks of the SXM part
at its 700 W limit (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
f32 outside them, 3.35 TB/s HBM3), NVLink 4 at 450 GB/s a direction as
the link, and the 85.02 GB that torch reports for the card (NVIDIA H100
80GB HBM3, 700 W). Unlike the reference, which always divides by its
bf16 peak, the compute peak follows the cell's parameter dtype.

The reference's ``HloModule``, ``parse_collectives`` and
``_tensor_bytes`` parse XLA's HLO text; the port lowers no HLO, so they
have no counterpart (their tests stay on the reference).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# wire multiplier per byte of *input* operand for ring algorithms on n devs
WIRE_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: float(n - 1),      # operand is the shard
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


@dataclass(frozen=True)
class H100:
    """One NVIDIA H100 SXM (80GB HBM3, 700 W): dense peaks from NVIDIA's
    data sheet, NVLink 4 a direction, and the card's memory as torch
    reports it (``chip_smoke.py`` phase 20)."""
    name: str = "NVIDIA H100 80GB HBM3, 700 W"
    peak_flops_bf16: float = 989e12
    peak_flops_f32: float = 67e12
    hbm_bw: float = 3.35e12
    link_bw: float = 450e9
    hbm_bytes: float = 85.02e9

    def peak_flops(self, dtype: str) -> float:
        """The peak for parameters of ``dtype`` ("float32" or
        "bfloat16")."""
        return self.peak_flops_f32 if dtype == "float32" \
            else self.peak_flops_bf16


H100_SXM = H100()


@dataclass
class CollectiveStats:
    op: str
    count: int = 0            # collectives planned
    dynamic_count: int = 0    # the same: a planned step runs each once
    operand_bytes: int = 0
    wire_bytes: float = 0.0


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_operand_bytes: float
    coll_wire_bytes: float
    coll_counts: Dict[str, int]
    model_flops_total: float
    flash_bytes_per_device: float = 0.0
    compute_s: float = 0.0
    memory_s: float = 0.0
    memory_s_flash_adjusted: float = 0.0
    collective_s: float = 0.0
    collective_wire_s: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0
    roofline_fraction: float = 0.0
    memory_per_device_gb: float = -1.0
    compile_seconds: float = 0.0
    param_dtype: str = "bfloat16"
    hardware: str = H100_SXM.name

    def finalize(self, hw: H100 = H100_SXM) -> "Roofline":
        peak = hw.peak_flops(self.param_dtype)
        self.hardware = hw.name
        self.compute_s = self.flops_per_device / peak
        self.memory_s = self.bytes_per_device / hw.hbm_bw
        self.memory_s_flash_adjusted = (
            (self.bytes_per_device - self.flash_bytes_per_device)
            / hw.hbm_bw)
        self.collective_s = self.coll_operand_bytes / hw.link_bw
        self.collective_wire_s = self.coll_wire_bytes / hw.link_bw
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        total_flops = self.flops_per_device * self.chips
        self.useful_ratio = (self.model_flops_total / total_flops
                             if total_flops else 0.0)
        # fraction of the compute roofline achieved if the step ran at the
        # max of the three terms (perfect overlap assumption)
        bound = max(terms.values())
        ideal = self.model_flops_total / (self.chips * peak)
        self.roofline_fraction = ideal / bound if bound else 0.0
        return self

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{self.mesh},{self.chips},"
                f"{self.compute_s*1e3:.2f}ms,{self.memory_s*1e3:.2f}ms,"
                f"{self.collective_s*1e3:.2f}ms,{self.dominant},"
                f"useful={self.useful_ratio:.2f},"
                f"roofline={self.roofline_fraction:.2f}")


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N_active*D train, 2*N_active*D forward-only."""
    n = cfg.active_param_count()
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * shape.tokens


def collective_stats(planned: Iterable[Tuple[str, int, int]]
                     ) -> Dict[str, CollectiveStats]:
    """(op, operand bytes, group size) records -> stats per op, with the
    ring wire factor at the group's size (at least 2)."""
    stats = {op: CollectiveStats(op) for op in _COLLECTIVES}
    for op, nbytes, group in planned:
        st = stats[op]
        st.count += 1
        st.dynamic_count += 1
        st.operand_bytes += int(nbytes)
        st.wire_bytes += nbytes * WIRE_FACTOR[op](max(group, 2))
    return stats


def analyze(arch: str, shape_name: str, mesh_name: str, chips: int,
            counts: dict, collectives, cfg, shape,
            param_dtype: str = "bfloat16", compile_seconds: float = 0.0,
            memory_per_device_gb: float = -1.0,
            hw: H100 = H100_SXM) -> Roofline:
    """The roofline of one cell from an ``OpCounter``'s ``totals()``
    (``counts``) and the planned ``collectives``."""
    colls = collective_stats(collectives)
    r = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=float(counts["flops"]),
        bytes_per_device=float(counts["bytes"]),
        coll_operand_bytes=sum(c.operand_bytes for c in colls.values()),
        coll_wire_bytes=sum(c.wire_bytes for c in colls.values()),
        coll_counts={k: v.count for k, v in colls.items() if v.count},
        model_flops_total=model_flops(cfg, shape),
        compile_seconds=compile_seconds,
        memory_per_device_gb=memory_per_device_gb,
        param_dtype=param_dtype,
    )
    return r.finalize(hw)
