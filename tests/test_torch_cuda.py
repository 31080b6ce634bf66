"""The port's CUDA kernels on the card, each against its plain version.

These need an NVIDIA GPU (the kernels have no CPU mode) and skip without
one. The file imports only torch, numpy and ``repro_torch``, so it also
runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: quantize, dequantize, parse and the field classifier are
bit/byte-exact; the f32 matmul is within ``1e-5 * k / 128`` of the f32
library product (no TF32 on either side), bf16 within ``3e-2``. K6
attention is within 2e-4 of its plain version in f32 (the reference's
tolerance; sums in another order), and in bf16 within 2e-4 plus one
bf16 step of the result (2^-7 relative: bf16 keeps 8 significant
bits). K7 ``ssd_scan`` is within 2e-5 of its plain version in f32 and
6e-2 in bf16 (the reference's ``tests/test_kernels.py`` tolerances); its
final state, f32 in both dtypes, within 2e-5. Under autograd, K6's and
K7's gradients are within the same 2e-4 and 2e-5 of autograd's through
the plain versions, and one ``tiny`` train step on the card is within
1e-5 (loss, relative) and 1e-4 of each gradient leaf's largest |value|
of the same step on the CPU. M-RoPE on the card is within 1e-5 of the
CPU's, and a full-width seamless-m4t layer's encoder output and logits
within 1e-4 of their largest |value| of the CPU's. A knob sweep of a
CUDA engine gives a CPU engine's surface and choice exactly (its scores
are functions of counts).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.lookaside import ControlMsg, LookasideBlock
from repro_torch.core.rdma import RDMAEngine
from repro_torch.core.streaming import (Drop, Forward, Handler, MatchTable,
                                        RXRing, StreamDispatcher,
                                        TrafficRouter, make_roce_header)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.lc_offload import (MM_WORKLOAD, QUANT_ROW,
                                            STREAM_PARSER_WORKLOAD,
                                            STREAM_QUANT_WORKLOAD,
                                            register_default_kernels)
from repro_torch.kernels.packet_parser import (parse_packet_fields,
                                               parse_packet_fields_plain,
                                               parse_packets,
                                               parse_packets_plain)
from repro_torch.kernels.quantize_stream import (dequantize_stream,
                                                 dequantize_stream_plain,
                                                 quantize_stream,
                                                 quantize_stream_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.kernels.systolic_mm import systolic_mm, systolic_mm_plain

RNG = np.random.default_rng(77)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rows(n, chunk):
    x = (RNG.standard_normal((n, chunk))
         * RNG.uniform(0.01, 100.0, (n, 1))).astype(np.float32)
    x[n // 2] = 0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantize_round_trip_matches_plain(cuda, chunk, dtype):
    x = torch.from_numpy(_rows(64, chunk)).to(cuda).to(dtype)
    x[3, 7] = float("nan")
    before = quantize_stream.launches
    q, s = quantize_stream(x, chunk=chunk)
    assert quantize_stream.launches == before + 1
    pq, ps = quantize_stream_plain(x)
    torch.testing.assert_close(s, ps, rtol=0, atol=0, equal_nan=True)
    keep = torch.arange(64, device=cuda) != 3      # NaN row: codes free
    assert torch.equal(q[keep], pq[keep])
    for out_dtype in (torch.float32, torch.bfloat16):   # row 3 is NaN
        torch.testing.assert_close(
            dequantize_stream(q, s, out_dtype=out_dtype),
            dequantize_stream_plain(q, s, out_dtype), rtol=0, atol=0,
            equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 13, 4096])
def test_cuda_parse_packets_matches_plain(cuda, n):
    pkts = RNG.integers(0, 256, size=(n, 64)).astype(np.uint8)
    pkts[::2, 12:14] = [0x08, 0x00]
    pkts[::2, 23] = 17
    pkts[::2, 36:38] = [18, 183]
    pkts[::2, 42] = RNG.integers(0, 20, size=pkts[::2].shape[0])
    t = torch.from_numpy(pkts).to(cuda)
    assert torch.equal(parse_packets(t), parse_packets_plain(t))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 4096, 65536])
def test_cuda_parse_packet_fields_matches_plain(cuda, n):
    pkts = RNG.integers(0, 256, size=(n, 64)).astype(np.uint8)
    pkts[::2, 12:14] = [0x08, 0x00]
    pkts[::2, 23] = 17
    pkts[::2, 36:38] = [18, 183]
    pkts[1::4, 36:38] = [0x23, 0x28]              # non-RoCE port 9000
    t = torch.from_numpy(pkts).to(cuda)
    before = parse_packet_fields.launches
    got = parse_packet_fields(t)
    assert parse_packet_fields.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n, 8)
    assert torch.equal(got, parse_packet_fields_plain(t))


@pytest.mark.cuda
def test_cuda_dispatch_pass_launches_k4_k3_and_k1(cuda):
    """One ingest and one dispatcher pass on the card: the classifier
    (K4), the parser handler (K3) and the quantize handler (K1) each
    launch, and the rows match their plain versions."""
    pool, depth = 1 << 15, 16
    eng = RDMAEngine(n_peers=2, pool_size=pool)
    blk = LookasideBlock(eng, peer=0, scratch_base=pool // 2,
                         scratch_size=pool // 4, pipeline_depth=4,
                         eager_writeback=False)
    register_default_kernels(blk)
    ring = RXRing(eng, peer=0, base=pool - depth * 64, depth=depth)
    meta_mr = eng.register_mr(1, 0, depth * 4)
    quant_mr = eng.register_mr(1, 2048, depth * QUANT_ROW)
    table = (MatchTable(default=Drop())
             .add(Forward(), priority=10, is_rdma=1)
             .add(Handler(STREAM_PARSER_WORKLOAD), udp_dport=9000)
             .add(Handler(STREAM_QUANT_WORKLOAD), udp_dport=9100))
    disp = StreamDispatcher(blk, ring, table, burst=4)
    disp.register_handler(STREAM_PARSER_WORKLOAD, 1, meta_mr.rkey, 0)
    disp.register_handler(STREAM_QUANT_WORKLOAD, 1, quant_mr.rkey, 2048)
    router = TrafficRouter(rx_ring=ring, table=table)
    assert router.device.type == "cuda"
    hdrs = np.stack([make_roce_header(4, i) if i % 3 == 0 else
                     make_roce_header(0, i, is_rdma=False,
                                      dport=9000 if i % 3 == 1 else 9100)
                     for i in range(24)])
    hdrs[2::3, 50:] = RNG.integers(0, 256, (8, 14))
    before = (parse_packet_fields.launches, parse_packets.launches,
              quantize_stream.launches)
    assert router.ingest_packets(hdrs)["streamed"] == 16
    assert disp.service() == 16
    torch.cuda.synchronize()
    after = (parse_packet_fields.launches, parse_packets.launches,
             quantize_stream.launches)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    meta = eng.read_buffer(1, 0, depth * 4).reshape(depth, 4)
    np.testing.assert_array_equal(
        meta[0::2], parse_packets_plain(torch.from_numpy(hdrs[1::3]))
        .numpy().astype(np.float32))
    quant = eng.read_buffer(1, 2048, depth * QUANT_ROW).reshape(
        depth, QUANT_ROW)
    q, s = quantize_stream_plain(torch.from_numpy(
        hdrs[2::3].astype(np.float32)))
    np.testing.assert_array_equal(quant[1::2, :64], q.float().numpy())
    np.testing.assert_array_equal(quant[1::2, 64:], s.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(512, 16, 512), (200, 33, 17),
                                   (256, 1024, 384), (1, 5, 130),
                                   (130, 37, 66), (1600, 64, 1700),
                                   (1601, 63, 1701)])
def test_cuda_systolic_mm_matches_plain(cuda, m, k, n):
    x = torch.from_numpy(RNG.standard_normal((m, k)).astype(np.float32))
    y = torch.from_numpy(RNG.standard_normal((k, n)).astype(np.float32))
    x, y = x.to(cuda), y.to(cuda)
    tol = 1e-5 * k / 128
    torch.testing.assert_close(systolic_mm(x, y), systolic_mm_plain(x, y),
                               rtol=tol, atol=tol)
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    torch.testing.assert_close(systolic_mm(xb, yb).float(),
                               systolic_mm_plain(xb, yb).float(),
                               rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(
        systolic_mm(xb, yb, out_dtype=torch.float32),
        systolic_mm_plain(xb, yb, torch.float32), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_systolic_mm_misaligned_view(cuda, dtype):
    """Operands that are contiguous views one element into their storage
    (not 16-byte aligned), with K and N multiples of 4: the kernel takes
    its masked scalar loads and matches its plain version."""
    m, k, n = 300, 64, 260
    xs = torch.from_numpy(RNG.standard_normal(m * k + 1).astype(
        np.float32)).to(cuda).to(dtype)
    ys = torch.from_numpy(RNG.standard_normal(k * n + 3).astype(
        np.float32)).to(cuda).to(dtype)
    x, y = xs[1:].view(m, k), ys[3:].view(k, n)
    assert x.is_contiguous() and x.data_ptr() % 16
    tol = 1e-5 * k / 128 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(systolic_mm(x, y).float(),
                               systolic_mm_plain(x, y).float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_cuda_systolic_mm_error_within_f32_bound(cuda):
    """2048^3 f32 against a float64 product: every element within the
    f32 bound of a k-term sum, ``k * 2^-24 * (|A| @ |B|)``. A TF32
    product (10 mantissa bits) misses it by orders of magnitude."""
    m = k = n = 2048
    x = torch.from_numpy(RNG.standard_normal((m, k)).astype(np.float32))
    y = torch.from_numpy(RNG.standard_normal((k, n)).astype(np.float32))
    x, y = x.to(cuda), y.to(cuda)
    got = systolic_mm(x, y).double()
    want = x.double() @ y.double()
    bound = k * 2.0 ** -24 * (x.double().abs() @ y.double().abs())
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
def test_cuda_offloaded_matmul_launches_the_kernel(cuda):
    """Through the engine on the card: the Lookaside kernel gets device
    tensors, so the CUDA kernel (not the plain version) runs."""
    m, k, n = 64, 32, 48
    eng = RDMAEngine(n_peers=2, pool_size=1 << 14)
    assert eng.pool.device.type == "cuda"
    blk = LookasideBlock(eng, peer=0, scratch_base=1 << 13)
    register_default_kernels(blk)
    A = RNG.standard_normal((m, k)).astype(np.float32)
    B = RNG.standard_normal((k, n)).astype(np.float32)
    out = m * k + k * n
    mr = eng.register_mr(1, 0, out + m * n)
    eng.write_buffer(1, 0, A.ravel())
    eng.write_buffer(1, m * k, B.ravel())
    before = systolic_mm.launches
    blk.dispatch(ControlMsg(MM_WORKLOAD, (1, mr.rkey, 0, m * k, out,
                                          m, k, n)))
    assert blk.poll(MM_WORKLOAD).ok
    assert systolic_mm.launches == before + 1
    got = eng.read_buffer(1, out, m * n).reshape(m, n)
    tol = 1e-5 * k / 128
    np.testing.assert_allclose(got, A.astype(np.float64) @ B,
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d,sq,skv,causal,window,hq,hkv,dtype", [
    (16, 63, 63, True, 0, 4, 2, torch.float32),
    (64, 512, 512, True, 0, 32, 4, torch.float32),
    (64, 1000, 1000, True, 0, 8, 1, torch.float32),
    (128, 1, 1, True, 0, 4, 4, torch.float32),
    (128, 63, 200, False, 0, 4, 2, torch.float32),
    (32, 1, 40, False, 0, 2, 1, torch.float32),
    (64, 512, 512, True, 32, 8, 8, torch.float32),
    (64, 512, 512, True, 1024, 25, 5, torch.float32),
    (64, 768, 768, True, 0, 25, 5, torch.float32),
    (64, 512, 512, True, 0, 8, 2, torch.bfloat16),
    (16, 1000, 1000, False, 100, 2, 1, torch.bfloat16),
    (64, 100, 177, False, 0, 4, 2, torch.float32),
    (64, 130, 77, False, 0, 4, 4, torch.bfloat16),
    (64, 300, 300, True, 40, 4, 1, torch.float32),
    (32, 200, 200, True, 100, 2, 2, torch.bfloat16),
    (128, 333, 333, True, 0, 8, 1, torch.float32),
    (128, 200, 150, False, 70, 4, 2, torch.bfloat16),
    (16, 77, 130, True, 0, 4, 1, torch.bfloat16),
    (64, 190, 190, True, 0, 10, 2, torch.bfloat16),
    (32, 129, 129, True, 0, 16, 2, torch.float32),
])
def test_cuda_flash_attention_matches_plain(cuda, d, sq, skv, causal,
                                            window, hq, hkv, dtype):
    def rand(*shape):
        return torch.from_numpy(RNG.standard_normal(shape).astype(
            np.float32)).to(cuda).to(dtype)

    q, k, v = rand(2, sq, hq, d), rand(2, skv, hkv, d), rand(2, skv, hkv, d)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=2e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_f32_is_not_tf32(cuda):
    """K6 in f32 at the tinyllama prefill shape (8 x 512, 32 q heads over
    4 kv heads of 64, causal) against a float64 oracle, within 1e-5: a
    3xTF32 or f32 route passes, a single TF32 product (~1e-3 here) does
    not."""
    def rand(*shape):
        return torch.from_numpy(RNG.standard_normal(shape).astype(
            np.float32)).to(cuda)

    b, s, hq, hkv, d = 8, 512, 32, 4, 64
    q, k, v = rand(b, s, hq, d), rand(b, s, hkv, d), rand(b, s, hkv, d)
    got = flash_attention(q, k, v, causal=True).double()
    qg = q.double().reshape(b, s, hkv, hq // hkv, d) * d ** -0.5
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double())
    pos = torch.arange(s, device=cuda)
    sc = sc.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    want = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(sc, dim=-1),
                        v.double()).reshape(b, s, hq, d)
    err = (got - want).abs().max().item()
    assert err <= 1e-5, err


@pytest.mark.cuda
def test_cuda_flash_attention_flat_heads_and_bad_head_dim(cuda):
    q = torch.randn((6, 70, 64), device=cuda)
    k, v = torch.randn((6, 90, 64), device=cuda), torch.randn(
        (6, 90, 64), device=cuda)
    torch.testing.assert_close(
        flash_attention(q, k, v, causal=False),
        flash_attention_plain(q[:, :, None], k[:, :, None], v[:, :, None],
                              causal=False)[:, :, 0], rtol=2e-4, atol=2e-4)
    bad = torch.randn((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_attention(bad, bad, bad)
    # a contiguous view one element into its storage is not 16-byte
    # aligned: the wrapper refuses it, and nothing runs in its place
    off = torch.randn(1 * 8 * 2 * 64 + 1, device=cuda)[1:].view(1, 8, 2, 64)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        flash_attention(off, off, off)
    assert flash_attention.launches == before


@pytest.mark.cuda
def test_cuda_prefill_launches_k6_once_per_layer(cuda):
    """The tiny model served on the card: a prefill from position 0
    launches K6 once per layer, decode launches none, and the logits
    match the full forward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.serve import decode_step, prefill_step

    cfg = get_config("tiny")
    params = init_params(cfg, 0)
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 13))).to(cuda)
    full, _, _ = forward(params, cfg, {"tokens": toks})
    caches = init_caches(cfg, 2, 16, torch.float32)
    before = flash_attention.launches
    lg, caches = prefill_step(params, cfg, {"tokens": toks[:, :12]}, caches)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers
    lg2, _ = decode_step(params, cfg, toks[:, 12:13], caches, 12)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers
    torch.testing.assert_close(lg[:, 0], full[:, 11], rtol=5e-5, atol=5e-5)
    torch.testing.assert_close(lg2[:, 0], full[:, 12], rtol=5e-5, atol=5e-5)


def _scan_case(cuda, b, s, nh, hd, n, seeded, g=1):
    """Model-like SSD inputs on the card: x, B, C standard normal, dt
    uniform in (0.1, 0.9), the model's a = -linspace(1, 16, nh)."""
    f = np.float32
    x = torch.from_numpy(RNG.standard_normal((b, s, nh, hd)).astype(f))
    dt = torch.from_numpy(RNG.uniform(0.1, 0.9, (b, s, nh)).astype(f))
    a = torch.from_numpy(-np.linspace(1.0, 16.0, nh).astype(f))
    bm, cm = (torch.from_numpy(RNG.standard_normal((b, s, g, n)).astype(f))
              for _ in "bc")
    init = (torch.from_numpy(RNG.standard_normal((b, nh, hd, n)).astype(f))
            if seeded else None)
    return [None if t is None else t.to(cuda)
            for t in (x, dt, a, bm, cm, init)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,n,chunk,s,nh,seeded,dtype", [
    (16, 16, 8, 32, 1, False, torch.float32),
    (16, 32, 12, 48, 4, True, torch.float32),
    (16, 128, 48, 96, 3, True, torch.bfloat16),
    (64, 128, 256, 512, 2, True, torch.float32),
    (64, 128, 256, 512, 2, False, torch.bfloat16),
    (64, 32, 48, 144, 32, True, torch.float32),
    (64, 16, 256, 512, 50, True, torch.float32),
    (64, 16, 12, 36, 50, False, torch.bfloat16),
    (32, 64, 12, 36, 8, True, torch.float32),
    (32, 128, 48, 144, 5, True, torch.bfloat16),
    (16, 16, 4096, 4096, 1, True, torch.float32),
])
def test_cuda_ssd_scan_matches_plain(cuda, hd, n, chunk, s, nh, seeded,
                                     dtype):
    x, dt, a, bm, cm, init = _scan_case(cuda, 2, s, nh, hd, n, seeded)
    x = x.to(dtype)
    before = ssd_scan.launches
    y, final = ssd_scan(x, dt, a, bm, cm, chunk=chunk, init_state=init,
                        return_final_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    assert final.dtype == torch.float32 and final.shape == (2, nh, hd, n)
    want_y, want_f = ssd_scan_plain(x, dt, a, bm, cm, chunk, init)
    tol = 6e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(final, want_f, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_ssd_scan_raises_rather_than_falls_back(cuda):
    """n_groups != 1, a non-f32 dt and a bf16 x at an odd element offset
    raise on the card; a head_dim without an instance and a chunk longer
    than the kernel's largest (4096) are refused by the launcher, which
    raises; none of them launches."""
    x, dt, a, bm, cm, _ = _scan_case(cuda, 1, 32, 4, 16, 16, False, g=2)
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="n_groups"):
        ssd_scan(x, dt, a, bm, cm, chunk=16)
    x, dt, a, bm, cm, _ = _scan_case(cuda, 1, 32, 2, 48, 16, False)
    with pytest.raises(RuntimeError, match="reconic_ssd_scan"):
        ssd_scan(x, dt, a, bm, cm, chunk=16)
    x, dt, a, bm, cm, _ = _scan_case(cuda, 1, 8192, 1, 64, 128, False)
    with pytest.raises(RuntimeError, match="reconic_ssd_scan"):
        ssd_scan(x, dt, a, bm, cm, chunk=8192)
    x, dt, a, bm, cm, _ = _scan_case(cuda, 1, 32, 2, 16, 16, False)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(x, dt.double(), a, bm, cm, chunk=16)
    odd = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    xb = odd[1:].view(x.shape)          # a bf16 view 2 bytes off alignment
    xb.copy_(x)
    with pytest.raises(ValueError, match="xh is not 4-byte aligned"):
        ssd_scan(xb, dt, a, bm, cm, chunk=16)
    assert ssd_scan.launches == before


def _rel_err(got, want):
    """max |got - want| / (1 + |want|), in float64."""
    got, want = got.double(), want.double()
    return ((got - want).abs() / (1.0 + want.abs())).max().item()


@pytest.mark.cuda
def test_cuda_ssd_scan_f32_is_not_tf32(cuda):
    """K7 in f32 at mamba2-370m's prefill shape (8 x 512, 32 heads of 64,
    d_state 128, chunk 256, seeded) against its plain version in float64
    (on the f32 in-order cumsum): y and the final state within 2e-5
    relative to 1 + |value|, the bound ``tests/test_torch_ssd_numerics.py``
    sets. The route meets it there; one TF32 product in any of the four
    products (~1e-2 off) does not."""
    x, dt, a, bm, cm, init = _scan_case(cuda, 8, 512, 32, 64, 128, True)
    y, final = ssd_scan(x, dt, a, bm, cm, chunk=256, init_state=init,
                        return_final_state=True)
    want_y, want_f = ssd_scan_plain(x, dt, a, bm, cm, 256, init,
                                    dtype=torch.float64)
    err = max(_rel_err(y, want_y), _rel_err(final, want_f))
    assert err <= 2e-5, err


@pytest.mark.cuda
def test_cuda_ssd_scan_deterministic_prefix_and_cumsum(cuda):
    """Two calls give the same bits; a scan over 768 tokens and one over
    its first 512 give the same bits on those 512 positions (chunk c's
    outputs depend only on chunk c and the state before it); and the
    kernel's in-chunk cumsum, which the launcher leaves at the head of
    its scratch, equals ``_cumsum_in_order`` bit for bit."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import _cumsum_in_order, work_floats

    b, nh, hd, n, chunk = 2, 4, 64, 128, 256
    x, dt, a, bm, cm, init = _scan_case(cuda, b, 768, nh, hd, n, True)
    y1, f1 = ssd_scan(x, dt, a, bm, cm, chunk=chunk, init_state=init,
                      return_final_state=True)
    y2, f2 = ssd_scan(x, dt, a, bm, cm, chunk=chunk, init_state=init,
                      return_final_state=True)
    assert torch.equal(y1, y2) and torch.equal(f1, f2)
    ws = torch.empty(work_floats(b, 768, nh, hd, n, chunk), device=cuda)
    y4, f4 = torch.empty_like(y1), torch.empty_like(f1)
    _build.launch("reconic_ssd_scan", x.data_ptr(), dt.data_ptr(),
                  a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                  init.data_ptr(), y4.data_ptr(), f4.data_ptr(),
                  ws.data_ptr(), ws.numel(), b, nh, 768, hd, n, chunk, 0,
                  _build.stream_ptr(x.device))
    torch.cuda.synchronize()
    assert torch.equal(y4, y1) and torch.equal(f4, f1)
    y3 = ssd_scan(x[:, :512].contiguous(), dt[:, :512].contiguous(), a,
                  bm[:, :512].contiguous(), cm[:, :512].contiguous(),
                  chunk=chunk, init_state=init)
    assert torch.equal(y3, y1[:, :512])
    want = _cumsum_in_order((dt * a).reshape(b, 3, chunk, nh))
    assert torch.equal(ws[:b * 768 * nh].view(b, 768, nh),
                       want.reshape(b, 768, nh))


@pytest.mark.cuda
def test_cuda_ssd_scan_underflow_range(cuda):
    """The model's decay range (a = -linspace(1, 16)) with dt up to 4 over
    64-long chunks: exp(cum) underflows through the subnormals to 0 inside
    a chunk, and the kernel stays finite and within 2e-5 of its plain
    version, seeded and not."""
    nh = 16
    for seeded in (True, False):
        x, _, a, bm, cm, init = _scan_case(cuda, 2, 128, nh, 16, 16, seeded)
        dt = torch.from_numpy((RNG.integers(2, 17, (2, 128, nh)) / 4.0)
                              .astype(np.float32)).to(cuda)
        cum = torch.cumsum(dt[0, :64] * a, dim=0)
        assert bool((torch.exp(cum) == 0).any())
        y, final = ssd_scan(x, dt, a, bm, cm, chunk=64, init_state=init,
                            return_final_state=True)
        assert torch.isfinite(y).all() and torch.isfinite(final).all()
        want_y, want_f = ssd_scan_plain(x, dt, a, bm, cm, 64, init)
        torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(final, want_f, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tiny-ssm", "hymba-1.5b-smoke"])
def test_cuda_ssm_prefill_launches_k7_once_per_layer(cuda, arch):
    """SSM and hybrid models served on the card: prefill launches K7 once
    per layer (and K6 too for hybrid heads), decode launches neither, and
    prefill + decode logits match a forward over 32 tokens within 5e-5."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.serve import decode_step, prefill_step

    cfg = get_config(arch)
    params = init_params(cfg, 0)
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 32))).to(cuda)
    full, _, _ = forward(params, cfg, {"tokens": toks})
    caches = init_caches(cfg, 2, 40, torch.float32)
    k6, k7 = flash_attention.launches, ssd_scan.launches
    lg, caches = prefill_step(params, cfg, {"tokens": toks[:, :16]}, caches)
    torch.cuda.synchronize()
    hybrid = cfg.hybrid_parallel_heads
    assert ssd_scan.launches == k7 + cfg.num_layers
    assert flash_attention.launches == k6 + (cfg.num_layers if hybrid else 0)
    lg2, _ = decode_step(params, cfg, toks[:, 16:17], caches, 16)
    torch.cuda.synchronize()
    assert ssd_scan.launches == k7 + cfg.num_layers
    assert flash_attention.launches == k6 + (cfg.num_layers if hybrid else 0)
    torch.testing.assert_close(lg[:, 0], full[:, 15], rtol=5e-5, atol=5e-5)
    torch.testing.assert_close(lg2[:, 0], full[:, 16], rtol=5e-5, atol=5e-5)


# ---------------------------------------------------------------------------
# K6 and K7 under autograd, and a train step on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d,s,hq,hkv,window,dtype", [
    (64, 128, 8, 2, 0, torch.float32),
    (16, 63, 4, 4, 20, torch.float32),
    (64, 96, 4, 1, 0, torch.bfloat16),
])
def test_cuda_flash_attention_grads_match_plain(cuda, d, s, hq, hkv,
                                                window, dtype):
    """Under grad mode K6's output carries a ``grad_fn`` (the forward is
    still one launch), and its gradients for q, k and v equal
    ``torch.autograd.grad`` of the plain version within K6's 2e-4 (bf16:
    plus one bf16 step)."""
    def rand(*shape):
        return torch.from_numpy(RNG.standard_normal(shape).astype(
            np.float32)).to(cuda).to(dtype).requires_grad_()

    q, k, v = rand(2, s, hq, d), rand(2, s, hkv, d), rand(2, s, hkv, d)
    w = torch.from_numpy(RNG.standard_normal((2, s, hq, d)).astype(
        np.float32)).to(cuda).to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    assert flash_attention.launches == before + 1
    assert out.grad_fn is not None
    got = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    assert flash_attention.launches == before + 1       # plain backward
    ref = flash_attention_plain(q, k, v, causal=True, window=window)
    want = torch.autograd.grad((ref.float() * w.float()).sum(), (q, k, v))
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-4
    for g, e in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), e.float(), rtol=rtol,
                                   atol=2e-4)
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
def test_cuda_ssd_scan_grads_match_plain(cuda, seeded):
    """K7's outputs carry a ``grad_fn``; the gradients for xh, dt, a,
    bm, cm and the initial state, through y and the final state, equal
    ``torch.autograd.grad`` of the plain version within 2e-5."""
    x, dt, a, bm, cm, init = _scan_case(cuda, 2, 96, 4, 16, 32, seeded)
    inputs = [t for t in (x, dt, a, bm, cm, init) if t is not None]
    for t in inputs:
        t.requires_grad_()
    wy = torch.randn(x.shape, device=cuda)
    wf = torch.randn((2, 4, 16, 32), device=cuda)

    def loss(y, final):
        return (y * wy).sum() + (final * wf).sum()

    before = ssd_scan.launches
    y, final = ssd_scan(x, dt, a, bm, cm, chunk=32, init_state=init,
                        return_final_state=True)
    assert ssd_scan.launches == before + 1
    assert y.grad_fn is not None and final.grad_fn is not None
    got = torch.autograd.grad(loss(y, final), inputs)
    want = torch.autograd.grad(
        loss(*ssd_scan_plain(x, dt, a, bm, cm, 32, init)), inputs)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_tiny_train_step_matches_cpu(cuda):
    """One plain train step of ``tiny`` (remat on) on the card against
    the same step on the CPU from the same weights and batch: K6 launches
    twice per layer (forward and remat recompute), the loss within 1e-5
    relative and each unclipped gradient leaf within 1e-4 of the leaf's
    largest |value| (K6 and the GEMMs sum in another order)."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import init_params
    from repro_torch.train import init_adam, make_train_step

    cfg = get_config("tiny")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, remat=True)
    host = init_params(cfg, 0, device="cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    batch = SyntheticPipeline(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                         batch=4, seq_len=64)).batch_at(0)
    losses, grads = [], []
    for params, dev in ((host, "cpu"), (card, cuda)):
        step = make_train_step(cfg, tcfg)
        step.keep_grads = True
        before = flash_attention.launches
        loss, new_params, _ = step(params, init_adam(params), {
            k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        if dev != "cpu":
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 2 * cfg.num_layers
            assert all(bool(torch.isfinite(p).all())
                       for p in tree_leaves(new_params))
        losses.append(float(loss))
        grads.append([g.cpu() for g in tree_leaves(step.last_grads)])
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    for g, e in zip(grads[1], grads[0]):
        torch.testing.assert_close(g, e, rtol=0,
                                   atol=1e-4 * float(e.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,causal,hq,hkv,dtype", [
    (512, 512, True, 16, 16, torch.float32),
    (100, 100, True, 4, 4, torch.float32),
    (63, 200, False, 4, 2, torch.float32),
    (130, 77, False, 2, 2, torch.float32),
    (1, 1, True, 2, 2, torch.float32),
    (512, 512, True, 16, 16, torch.bfloat16),
    (77, 130, True, 4, 1, torch.bfloat16),
    (200, 150, False, 2, 2, torch.bfloat16),
])
def test_cuda_flash_attention_mla_heads_match_plain(cuda, sq, skv, causal,
                                                    hq, hkv, dtype):
    """K6 at MLA's head dims, q and k 192 wide, v and the output 128:
    within 2e-4 of the plain version in f32 (plus one bf16 step in
    bf16), ragged Sq and Skv, causal and not; the scale is 192^-0.5."""
    def rand(*shape):
        return torch.from_numpy(RNG.standard_normal(shape).astype(
            np.float32)).to(cuda).to(dtype)

    q, k, v = rand(2, sq, hq, 192), rand(2, skv, hkv, 192), rand(
        2, skv, hkv, 128)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, sq, hq, 128)
    want = flash_attention_plain(q, k, v, causal=causal)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=2e-4)
    with pytest.raises(ValueError, match="head_dim 192 with v head_dim 64"):
        flash_attention(q, k, v[..., :64].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_mla_heads_grads_match_plain(cuda, dtype):
    """K6 at (192, 128) under autograd: one launch, and the gradients
    for q, k and v equal autograd's through the plain version within
    2e-4 (bf16: plus one bf16 step)."""
    def rand(*shape):
        return torch.from_numpy(RNG.standard_normal(shape).astype(
            np.float32)).to(cuda).to(dtype).requires_grad_()

    q, k, v = rand(2, 96, 4, 192), rand(2, 96, 4, 192), rand(2, 96, 4, 128)
    w = torch.from_numpy(RNG.standard_normal((2, 96, 4, 128)).astype(
        np.float32)).to(cuda).to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v, causal=True)
    want = torch.autograd.grad((ref.float() * w.float()).sum(), (q, k, v))
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-4
    for g, e in zip(got, want):
        assert g.dtype == dtype and g.shape == e.shape
        torch.testing.assert_close(g.float(), e.float(), rtol=rtol,
                                   atol=2e-4)


@pytest.mark.cuda
def test_cuda_mla_moe_prefill_launches_k6_once_per_layer(cuda):
    """deepseek-v2-lite's structure at a small width but MLA's full head
    dims (192 for q.k, 128 for v), served on the card: K6 once per layer
    in a prefill and a forward, none in decode, and prefill + decode
    within 5e-5 of the full forward with capacity drops off."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.serve import decode_step, prefill_step

    cfg = get_config("deepseek-v2-lite-16b-smoke")
    cfg = dataclasses.replace(
        cfg, mla=get_config("deepseek-v2-lite-16b").mla,
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = init_params(cfg, 0)
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 13))).to(cuda)
    before = flash_attention.launches
    full, _, aux = forward(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers
    assert bool(torch.isfinite(aux))
    caches = init_caches(cfg, 2, 16, torch.float32)
    lg, caches = prefill_step(params, cfg, {"tokens": toks[:, :12]}, caches)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2 * cfg.num_layers
    lg2, _ = decode_step(params, cfg, toks[:, 12:13], caches, 12)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2 * cfg.num_layers
    torch.testing.assert_close(lg[:, 0], full[:, 11], rtol=5e-5, atol=5e-5)
    torch.testing.assert_close(lg2[:, 0], full[:, 12], rtol=5e-5, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,causal,hq,hkv,d", [
    (128, 128, False, 16, 16, 64),     # seamless-m4t's encoder
    (512, 128, False, 16, 16, 64),     # its cross-attention in prefill
    (1, 128, False, 16, 16, 64),       # and in a decode step
    (512, 512, True, 28, 4, 128),      # qwen2-vl-7b's prefill, GQA 7
])
def test_cuda_flash_attention_encdec_and_vlm_shapes(cuda, sq, skv, causal,
                                                    hq, hkv, d):
    """K6 at the shapes seamless-m4t-large-v2 and qwen2-vl-7b serve at (8
    sequences): not causal with Sq != Skv and Sq = 1, and 28 q heads over
    4 kv heads of 128; one launch, within 2e-4 of the plain version."""
    def rand(*shape):
        return torch.from_numpy(RNG.standard_normal(shape).astype(
            np.float32)).to(cuda)

    q, k, v = rand(8, sq, hq, d), rand(8, skv, hkv, d), rand(8, skv, hkv, d)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_apply_mrope_matches_cpu(cuda):
    """M-RoPE at qwen2-vl's head dim 128, distinct t/h/w ids, on the card
    against the CPU within 1e-5 (cos and sin of the same f32 angles)."""
    from repro_torch.models.layers import apply_mrope
    x = torch.from_numpy(RNG.standard_normal((2, 33, 4, 128)).astype(
        np.float32))
    ids = torch.from_numpy(RNG.integers(0, 600, (3, 2, 33)).astype(np.int32))
    want = apply_mrope(x, ids, 1e6, (16, 24, 24))
    got = apply_mrope(x.to(cuda), ids.to(cuda), 1e6, (16, 24, 24))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_seamless_block_matches_cpu(cuda):
    """One seamless-m4t-large-v2 layer of each stack at full width (d_model
    1024, 16 heads of 64, d_ff 8192) over 128 frames and 40 tokens: the
    encoder's output and a forward's logits on the card within 1e-4 of
    their largest |value| of the CPU's; K6 launched 3 times in the
    forward (encoder, self, cross) and 2 in a decode step."""
    import dataclasses
    from repro_torch._tree import tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.models.transformer import encode
    from repro_torch.serve import decode_step, model_inputs, prefill_step

    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2"),
                              num_layers=1, encoder_layers=1,
                              vocab_size=512)
    params = init_params(cfg, 0, device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    inp = model_inputs(cfg, 2, 512, seed=1, device="cpu")
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 40)))
    want = encode(params, cfg, inp["enc_embeds"])
    got = encode(on_card, cfg, inp["enc_embeds"].to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    before = flash_attention.launches
    batch = {"tokens": toks, **inp}
    want, _, _ = forward(params, cfg, batch)
    got, _, _ = forward(on_card, cfg, tree_map(lambda t: t.to(cuda), batch))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 3
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    card = tree_map(lambda t: t.to(cuda), {"tokens": toks, **inp})
    caches = init_caches(cfg, 2, 48, torch.float32)
    _, caches = prefill_step(on_card, cfg, {"tokens": card["tokens"][:, :39],
                                            "enc_embeds": card["enc_embeds"]},
                             caches)
    lg, _ = decode_step(on_card, cfg, card["tokens"][:, 39:40], caches, 39,
                        extra={"enc_embeds": card["enc_embeds"]})
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 3 + 3 + 2
    torch.testing.assert_close(lg[:, 0].cpu(), want[:, 39], rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_autotune_sweep_equals_the_cpu_sweep(cuda):
    """The knob sweep's trials run on the live engine's device; their
    counts, and so the surface and the choice, are the CPU's."""
    from repro_torch.core.rdma import AutoTuner, Opcode, TuningGrid, WQE

    def live(device):
        eng = RDMAEngine(n_peers=2, pool_size=4096, device=device)
        mr = eng.register_mr(1, 0, 1024)
        qp = eng.create_qp(0, 1)
        rng = np.random.default_rng(7)
        for i in range(8):
            ln = int(rng.integers(8, 48))
            eng.post_send(qp, WQE(Opcode.READ, qp.qp_num, wr_id=i,
                                  local_addr=int(rng.integers(0, 1024 - ln)),
                                  remote_addr=int(rng.integers(0, 1024 - ln)),
                                  length=ln, rkey=mr.rkey))
        eng.ring_sq_doorbell(qp)
        return eng

    grid = TuningGrid(ring_burst=(16, 32, 64), pipeline_depth=(1, 4),
                      flush_budget=(None, 8), qp_window=(None, 4))
    surfaces, chosen = [], []
    for device in ("cpu", cuda):
        tuner = AutoTuner(live(device), grid=grid, seed=7, passes=1,
                          rows=64)
        chosen.append(tuner.sweep(apply=False))
        surfaces.append([(r.tuning.key(), r.flushes, r.wqes, r.score)
                         for r in tuner.surface])
    assert chosen[0] == chosen[1]
    assert surfaces[0] == surfaces[1]


@pytest.mark.cuda
def test_cuda_two_ranks_share_the_card(cuda):
    """Two gloo ranks on the one card (``run_peers``): the ICITransport
    twin's pool byte-equal to a LocalTransport's on the card (-0.0
    words included), and ``compressed_all_reduce_group`` bit-equal to
    the leading-dim ``compressed_all_reduce``, K1 and K2 launched."""
    import _torch_ranks as R
    from repro_torch.launch.mesh import run_peers
    got = run_peers(R.cuda_two_rank_case, 2, device="cuda", timeout_s=300)
    for r in got:
        assert r["type"] == "ICITransport" and r["device"].startswith("cuda")
        assert np.array_equal(r["pool"].view(np.uint32),
                              r["local_pool"].view(np.uint32))
        assert np.array_equal(r["est"], r["lead"])
        assert np.array_equal(r["res"], r["lead_res"])
        assert r["launched"][0] > 0 and r["launched"][1] > 0
    assert np.array_equal(got[0]["est"], got[1]["est"])


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 32])
def test_cuda_counter_around_k6_equals_the_meta_count(cuda, window):
    """The operation counter around a real K6 call on the card charges
    what it charges around the same call on ``meta``: the kernel's own
    formula, one call, and no op of the launch; the card's call
    launches the kernel once, the meta call never."""
    from repro_torch.roofline.count import OpCounter
    q = torch.from_numpy(RNG.standard_normal((8, 512, 32, 64),
                                             np.float32)).to(cuda)
    k, v = (torch.from_numpy(RNG.standard_normal((8, 512, 4, 64),
                                                 np.float32)).to(cuda)
            for _ in range(2))
    totals = []
    for dev in (cuda, torch.device("meta")):
        qd, kd, vd = q.to(dev), k.to(dev), v.to(dev)
        n0 = flash_attention.launches
        with OpCounter((qd, kd, vd)) as counter:
            flash_attention(qd, kd, vd, window=window)
        torch.cuda.synchronize()
        totals.append((counter.flops, counter.bytes, counter.kernels,
                       flash_attention.launches - n0))
    (flops, nbytes, kernels, launched), meta = totals
    assert (flops, nbytes, kernels) == meta[:3]
    assert kernels["flash_attention"]["calls"] == 1
    assert (launched, meta[3]) == (1, 0)
