"""The port's roofline (``repro_torch.roofline``) against the reference's.

``model_flops``, the wire factors and ``Roofline.finalize`` are held
equal to ``repro.roofline.analysis`` exactly: ``finalize`` with the
reference's ``TPU_V5E`` figures injected into the port's ``H100``
dataclass (for this test only; the port's default is the H100). K6's
FLOP formula is held to a brute count of the mask the plain version
applies; the counter's rules (matmul FLOPs, bytes without views, peak
live bytes) on small ops; and the counter's totals of a step equal on
``meta`` and on the CPU, FLOPs, bytes and kernel charges alike.
"""
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.registry import ARCHS as J_ARCHS
from repro.core.rdma.cost_model import TPU_V5E
from repro.roofline import analysis as JA

from repro_torch.configs.base import (SHAPES, MeshConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cost,
                                                 visible_pairs)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_cost
from repro_torch.launch.dryrun import build_cell, trace
from repro_torch.roofline import analysis as TA
from repro_torch.roofline.count import OpCounter

CELLS = [(a, s) for a in J_ARCHS for s in J_SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    assert ARCHS[arch].name == J_ARCHS[arch].name
    want = JA.model_flops(J_ARCHS[arch], J_SHAPES[shape])
    assert TA.model_flops(ARCHS[arch], SHAPES[shape]) == want


@pytest.mark.parametrize("n", [2, 3, 8, 16, 32, 256, 512])
def test_wire_factors_equal_the_reference(n):
    assert set(TA.WIRE_FACTOR) == set(JA._WIRE_FACTOR)
    for op, f in JA._WIRE_FACTOR.items():
        assert TA.WIRE_FACTOR[op](n) == f(n)


# (flops, bytes, flash bytes, collective operand and wire bytes, chips):
# compute-, memory- and collective-bound
COUNTS = [(5e15, 1e11, 0.0, 1e8, 2e8, 256),
          (1e12, 4e12, 1e11, 0.0, 0.0, 512),
          (1e12, 1e9, 0.0, 5e11, 9.9e11, 8)]


@pytest.mark.parametrize("flops,nbytes,flash,coll,wire,chips", COUNTS)
def test_finalize_equals_the_reference_with_its_hardware(
        flops, nbytes, flash, coll, wire, chips):
    tpu = TA.H100(name="TPU v5e", peak_flops_bf16=TPU_V5E.peak_flops_bf16,
                  peak_flops_f32=TPU_V5E.peak_flops_bf16,
                  hbm_bw=TPU_V5E.hbm_bw, link_bw=TPU_V5E.ici_bw_per_link,
                  hbm_bytes=TPU_V5E.hbm_bytes)
    cfg, shape = J_ARCHS["qwen3-4b"], J_SHAPES["train_4k"]
    kw = dict(arch="qwen3-4b", shape="train_4k", mesh="single", chips=chips,
              flops_per_device=flops, bytes_per_device=nbytes,
              coll_operand_bytes=coll, coll_wire_bytes=wire,
              coll_counts={"all-reduce": 3},
              model_flops_total=JA.model_flops(cfg, shape),
              flash_bytes_per_device=flash)
    want = JA.Roofline(**kw).finalize()
    got = TA.Roofline(**kw, param_dtype="bfloat16").finalize(tpu)
    for f in ("compute_s", "memory_s", "memory_s_flash_adjusted",
              "collective_s", "collective_wire_s", "dominant",
              "useful_ratio", "roofline_fraction"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.row() == want.row()


def test_the_compute_peak_follows_the_param_dtype():
    kw = dict(arch="tiny", shape="train_4k", mesh="single", chips=1,
              flops_per_device=67e12, bytes_per_device=0.0,
              coll_operand_bytes=0.0, coll_wire_bytes=0.0, coll_counts={},
              model_flops_total=1.0)
    assert TA.Roofline(**kw, param_dtype="float32").finalize().compute_s \
        == 1.0
    assert TA.Roofline(**kw).finalize().compute_s == 67e12 / 989e12
    assert TA.H100_SXM.name == "NVIDIA H100 80GB HBM3, 700 W"


# (sq, skv, causal, window, hq, hkv, d, dv): causal, a causal window, a
# window without causality, GQA 7 at 128, MLA's 192/128, cross-attention
@pytest.mark.parametrize("sq,skv,causal,window,hq,hkv,d,dv", [
    (64, 64, True, 0, 4, 2, 16, 16),
    (96, 96, True, 17, 4, 4, 32, 32),
    (40, 40, False, 9, 2, 2, 16, 16),
    (50, 50, True, 0, 28, 4, 128, 128),
    (33, 33, True, 0, 16, 16, 192, 128),
    (48, 16, False, 0, 16, 16, 64, 64),
    (1, 16, False, 0, 16, 16, 64, 64),
])
def test_k6_formula_is_a_count_of_the_mask(sq, skv, causal, window, hq, hkv,
                                           d, dv):
    q_pos = torch.arange(sq)[:, None]
    k_pos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    pairs = int(mask.sum())
    assert visible_pairs(sq, skv, causal, window) == pairs
    b = 3
    q = torch.empty((b, sq, hq, d), device="meta")
    k = torch.empty((b, skv, hkv, d), device="meta")
    v = torch.empty((b, skv, hkv, dv), device="meta")
    flops, nbytes = flash_attention_cost(q, k, v, causal=causal,
                                         window=window)
    assert flops == 2 * (d + dv) * pairs * b * hq
    assert nbytes == 4 * (q.numel() + k.numel() + v.numel()
                          + b * sq * hq * dv)


def test_counter_rules_on_small_ops():
    x = torch.ones(8, 16)
    y = torch.ones(16, 4)
    with OpCounter((x, y)) as c:
        z = x @ y                       # mm: 2 m k n, x, y and z
        v = z.view(32)                  # a view: nothing
        v.add_(1.0)                     # in place: read and written
        w = torch.empty(1000)           # touches nothing
    assert c.flops == 2 * 8 * 16 * 4
    assert c.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 4 * 2 * 32
    assert c.input_bytes == 4 * (8 * 16 + 16 * 4)
    assert c.peak_bytes == c.input_bytes + 4 * 32 + 4 * 1000
    del w
    assert c.live == c.input_bytes + 4 * 32


def test_counter_charges_a_kernel_by_its_formula_alone():
    """Inside the charge the plain version's ops count nothing, so K6
    and K7 read the same on the CPU as their formulas."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 24, 4, 16), np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 24, 2, 16), np.float32))
    with OpCounter() as c:
        flash_attention(q, kv, kv, window=5)
    assert (c.flops, c.bytes) == flash_attention_cost(q, kv, kv, window=5)
    assert c.kernels == {"flash_attention": {
        "calls": 1, "flops": c.flops, "bytes": c.bytes}}
    x = torch.from_numpy(rng.standard_normal((1, 32, 2, 8), np.float32))
    dt = torch.full((1, 32, 2), 0.5)
    a = -torch.ones(2)
    bm = torch.from_numpy(rng.standard_normal((1, 32, 1, 4), np.float32))
    with OpCounter() as c:
        ssd_scan(x, dt, a, bm, bm, chunk=16)
    assert (c.flops, c.bytes) == ssd_scan_cost(x, dt, a, bm, bm, 16)


SMALL = ["tiny", "tiny-moe", "tiny-ssm", "seamless-m4t-large-v2-smoke",
         "qwen2-vl-7b-smoke", "deepseek-v2-lite-16b-smoke"]


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", SMALL)
def test_counts_equal_on_meta_and_on_the_cpu(arch, kind):
    """One device's step at 4 x 32 in f32 (train with remat), traced on
    ``meta`` and run on the CPU under the counter: FLOPs, bytes and each
    kernel's charges equal."""
    cfg = get_config(arch)
    shape = ShapeConfig("small", 32, 4, kind)
    mesh = MeshConfig((1,), ("data",))
    tcfg = TrainConfig(param_dtype="float32", remat=True)
    got = {}
    for dev in ("meta", "cpu"):
        fn, inputs, _ = build_cell(cfg, shape, mesh, tcfg, device=dev)
        got[dev] = trace(fn, inputs)
    for key in ("flops", "bytes", "kernels", "input_bytes"):
        assert got["meta"][key] == got["cpu"][key], key
    assert got["meta"]["flops"] > 0 and got["meta"]["kernels"]
