"""The port's CUDA kernels on the card, each against its plain version.

These need an NVIDIA GPU (the kernels have no CPU mode) and skip without
one. The file imports only torch, numpy, ``repro_torch`` and the served
shapes ``chip_smoke.py`` holds its kernels at, so it also runs where JAX
is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: quantize, dequantize, parse and the field classifier are
bit/byte-exact; the f32 matmul is within ``1e-5 * k / 128`` of the f32
library product (no TF32 on either side), bf16 within ``3e-2``. K6
attention is within 2e-4 of its plain version in f32 (the reference's
tolerance; sums in another order), and in bf16 within 2e-4 plus one
bf16 step of the result (2^-7 relative: bf16 keeps 8 significant
bits); in f32 over 4096 and 32768 keys its error against float64 is
within twice the plain f32 version's own, and in bf16 (the wgmma kernel)
over 512 to 32768 keys within twice the plain bf16 version's own. The
wgmma kernel is held to the bf16 tolerance, the TF32 wgmma kernel (f32)
to 2e-4, at GQA groups 1 to 8, ragged lengths, windows, rows without
keys and B * Hq at and past 65535, each call counted on its route; each
of the three routes also at query offsets (a sequence-parallel rank's
rows) against ``flash_attention_plain(q_offset=)``, with the same
tolerances.
K7 ``ssd_scan`` is within 2e-5 of its plain version in f32 and 6e-2 in bf16 (the reference's
``tests/test_kernels.py`` tolerances); its
final state, f32 in both dtypes, within 2e-5. Under autograd, K6's and
K7's gradients are within the same 2e-4 and 2e-5 of autograd's through
the plain versions (K6's with the blockwise backward of ``train_4k``:
f32 within 2e-4, bf16 within one bf16 step of each gradient's largest
|value|), and one ``tiny`` train step on the card is within
1e-5 (loss, relative) and 1e-4 of each gradient leaf's largest |value|
of the same step on the CPU; a 2-layer bf16 step of tinyllama-1.1b (K6)
and of mamba2-370m (K7) under the ``dots`` remat policy launches K6 and
K7 as under ``full``, its loss and gradient norm within 1e-4 relative
and each gradient leaf within one bf16 step of its largest |value| of
``full``'s; an MLA prefill by rows (the last of 8 ranks) launches K6 on
``wgmma`` at its offset, within 2e-4 plus one bf16 step of
``flash_attention_plain(q_offset=)``, and so does hymba-1.5b's attention
block with every projection whole on the last of 3 ranks, its rows
within the same of the unsharded block's. M-RoPE on the card is within 1e-5
of the CPU's, and a full-width seamless-m4t layer's encoder output and logits
within 1e-4 of their largest |value| of the CPU's. A knob sweep of a
CUDA engine gives a CPU engine's surface and choice exactly (its scores
are functions of counts).
"""
import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import (K6_CUT, K6_DECODE, K6_SERVED,  # noqa: E402
                        K7_SERVED)
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
from repro_torch.models.layers import _attention_blockwise
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
    before, routes = flash_attention.launches, _route_counts()
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_routed(routes, dtype, d, d, sq)
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,causal,window",
                         [row[1:] for row in K6_SERVED],
                         ids=[row[0] for row in K6_SERVED])
def test_cuda_flash_attention_bf16_at_served_shapes(cuda, b, sq, skv, hq, hkv,
                                                    d, dv, causal, window):
    """K6 in bf16 at the shapes the bf16 and train_4k cells give it
    (``chip_smoke.K6_SERVED``), against its plain
    version over slices of the query rows at their offset (the plain
    version's S x S scores at 32768 rows would not fit): the first, a
    middle and the last 256 rows, within 2e-4 plus one bf16 step."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sq + hq + d)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    q, k, v = rand(b, sq, hq, d), rand(b, skv, hkv, d), rand(b, skv, hkv, dv)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, hq, dv)
    rows = {(0, min(sq, 256)), (max(sq // 2 - 128, 0), min(sq // 2 + 128, sq)),
            (max(sq - 256, 0), sq)}
    for r0, r1 in sorted(rows):
        want = flash_attention_plain(q[:, r0:r1], k, v, causal=causal,
                                     window=window, q_offset=r0)
        torch.testing.assert_close(got[:, r0:r1].float(), want.float(),
                                   rtol=2.0 ** -7, atol=2e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_f32_is_not_tf32(cuda):
    """K6 in f32 at the tinyllama prefill shape (8 x 512, 32 q heads over
    4 kv heads of 64, causal) against a float64 oracle, within 1e-5: a
    3xTF32 or f32 route passes, a single TF32 product (~1e-3 here) does
    not. The call goes to the TF32 wgmma kernel."""
    def rand(*shape):
        return torch.from_numpy(RNG.standard_normal(shape).astype(
            np.float32)).to(cuda)

    b, s, hq, hkv, d = 8, 512, 32, 4, 64
    q, k, v = rand(b, s, hq, d), rand(b, s, hkv, d), rand(b, s, hkv, d)
    routes = _route_counts()
    got = flash_attention(q, k, v, causal=True).double()
    assert _assert_routed(routes, q.dtype, d, d, s) == "wgmma_tf32"
    qg = q.double().reshape(b, s, hkv, hq // hkv, d) * d ** -0.5
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double())
    pos = torch.arange(s, device=cuda)
    sc = sc.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    want = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(sc, dim=-1),
                        v.double()).reshape(b, s, hq, d)
    err = (got - want).abs().max().item()
    assert err <= 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("keys", [4096, 32768])
def test_cuda_flash_attention_f32_does_not_drift_with_key_count(cuda, keys):
    """K6 in f32 over one sequence of ``keys`` tokens at tinyllama's heads
    (32 q over 4 kv heads of 64, causal): the last 64 rows' error against
    float64, over the output's largest |value|, within twice the plain
    f32 version's own. O accumulated in the tensor cores' C across every
    KV tile drifts with the key count (3e-5 at 4096 keys, 2e-4 at 32768,
    against the plain version's 3e-6 and 6e-6), so the TF32 wgmma kernel,
    which takes the call, adds each tile's PV to O in f32."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(keys)
    q, k, v = (torch.randn((1, keys, h, 64), generator=gen, device=cuda)
               for h in (32, 4, 4))
    r0 = keys - 64
    qg = q[:, r0:].double().reshape(1, 64, 4, 8, 64) * 64 ** -0.5
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double())
    pos = torch.arange(keys, device=cuda)
    sc = sc.masked_fill(pos[r0:, None] < pos[None, :], float("-inf"))
    want = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(sc, dim=-1),
                        v.double()).reshape(1, 64, 32, 64)
    scale = want.abs().max().item()
    routes = _route_counts()
    got = flash_attention(q, k, v, causal=True)[:, r0:].double()
    assert _assert_routed(routes, q.dtype, 64, 64, keys) == "wgmma_tf32"
    plain = flash_attention_plain(q[:, r0:], k, v, causal=True,
                                  q_offset=r0).double()
    err = (got - want).abs().max().item() / scale
    plain_err = (plain - want).abs().max().item() / scale
    assert err <= 2 * plain_err, (err, plain_err)


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


def _route_counts():
    return dict(flash_attention.route_launches)


def _assert_routed(routes, dtype, d, dv, sq, n=1):
    """The ``n`` calls since ``routes`` was read went to the route that
    ``flash_attention_route`` gives their class, and no other; return
    it."""
    from repro_torch.kernels.flash_attention import flash_attention_route
    route = flash_attention_route(dtype, d, dv, sq)
    assert _route_counts() == {**routes, route: routes[route] + n}
    return route


def _wgmma_case(cuda, seed, b, sq, skv, hq, hkv, d, dv):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    return rand(b, sq, hq, d), rand(b, skv, hkv, d), rand(b, skv, hkv, dv)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv,sq,skv,hq,hkv,causal,window", [
    (64, 64, 1000, 1000, 8, 2, True, 0),
    (64, 64, 129, 129, 5, 1, True, 0),
    (64, 64, 1000, 1000, 7, 1, False, 0),
    (64, 64, 129, 1000, 8, 1, False, 0),
    (64, 64, 1000, 63, 4, 4, False, 0),
    (64, 64, 2048, 2048, 4, 1, True, 1024),
    (64, 64, 1000, 1000, 5, 5, True, 100),
    (64, 64, 1, 129, 4, 1, False, 0),
    (64, 64, 63, 63, 4, 4, True, 0),
    (128, 128, 1000, 1000, 8, 2, True, 0),
    (128, 128, 129, 129, 7, 1, True, 0),
    (128, 128, 1000, 1, 4, 1, False, 0),
    (128, 128, 300, 1000, 5, 1, False, 0),
    (128, 128, 1500, 1500, 8, 1, True, 1024),
    (128, 128, 63, 200, 4, 4, False, 0),
    (128, 128, 1, 1, 4, 4, True, 0),
    (192, 128, 1000, 1000, 4, 4, True, 0),
    (192, 128, 129, 129, 8, 1, True, 0),
    (192, 128, 1000, 700, 4, 1, False, 0),
    (192, 128, 1200, 1200, 4, 4, True, 1024),
    (192, 128, 1, 63, 4, 4, False, 0),
])
def test_cuda_flash_attention_wgmma_matches_plain(cuda, d, dv, sq, skv, hq,
                                                  hkv, causal, window):
    """The wgmma kernel (``csrc/flash_attention_sm90.cu``) against the
    plain version at each of its head-dim pairs, causal, not causal and
    with a window, GQA groups 1, 4, 5, 7 and 8, Sq and Skv that no tile
    divides and Skv < Sq, within 2e-4 plus one bf16 step. A call with
    more than 64 rows goes to it through ``flash_attention``; one with
    fewer is launched on it directly (the routing sends those to the
    split_kv kernel)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _wgmma_case(cuda, sq + skv + d + hq, 2, sq, skv, hq, hkv, d,
                          dv)
    before, routes = flash_attention.launches, _route_counts()
    if fa.flash_attention_route(q.dtype, d, dv, sq) == "wgmma":
        got = flash_attention(q, k, v, causal=causal, window=window)
    else:
        got = q.new_empty((2, sq, hq, dv))
        fa._launch("wgmma", q, k, v, got, causal, window, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert _route_counts() == {**routes, "wgmma": routes["wgmma"] + 1}
    assert got.dtype == torch.bfloat16 and got.shape == (2, sq, hq, dv)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,window", [(700, 0, 0), (1000, 300, 64)])
def test_cuda_flash_attention_wgmma_rows_without_keys_write_zero(cuda, sq,
                                                                 skv,
                                                                 window):
    """Rows that see no key write 0 on the wgmma route: every row when
    there are no keys, and, causal with a window of 64 over 300 keys,
    every row from 363 on."""
    q, k, v = _wgmma_case(cuda, 3, 2, sq, skv, 8, 2, 64, 64)
    routes = _route_counts()
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert _route_counts()["wgmma"] == routes["wgmma"] + 1
    first_blind = skv + window - 1 if skv else 0
    assert bool((got[:, first_blind:] == 0).all())
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,sq", [(4369, 15, 129), (4369, 15, 64),
                                     (4096, 16, 129)])
def test_cuda_flash_attention_many_heads(cuda, b, hq, sq):
    """B * Hq at and past 65535: the wgmma route puts (sequence, head)
    pairs on grid.x and takes 65536; the split_kv route (64 rows) puts
    (sequence, kv head) pairs there. Checked on the first and last
    sequences."""
    from repro_torch.kernels.flash_attention import flash_attention_route
    q, k, v = _wgmma_case(cuda, b + sq, b, sq, 64, hq, 1, 64, 64)
    route = flash_attention_route(q.dtype, 64, 64, sq)
    assert route == ("wgmma" if sq > 64 else "split_kv")
    routes = _route_counts()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _route_counts()[route] == routes[route] + 1
    for i in (0, b - 1):
        want = flash_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                     causal=True)
        torch.testing.assert_close(got[i:i + 1].float(), want.float(),
                                   rtol=2.0 ** -7, atol=2e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_routes_and_misaligned_input(cuda):
    """Each route's launch count moves with the calls routed to it (bf16
    at (32, 32) to mma.sync, a bf16 call of 64 rows and an f32 one at the
    served dims to split_kv, bf16 there over 64 rows to wgmma, f32 there
    over 64 rows to wgmma_tf32),
    and a misaligned input on either wgmma route raises with no launch
    on any."""
    before, routes = flash_attention.launches, _route_counts()
    q, k, v = _wgmma_case(cuda, 9, 1, 200, 200, 4, 2, 128, 128)
    flash_attention(q, k, v)
    flash_attention(q[:, :64].contiguous(), k, v)
    flash_attention(q.float(), k.float(), v.float())
    flash_attention(q[:, :64].float(), k.float(), v.float())
    s = torch.randn((1, 100, 2, 32), device=cuda).bfloat16()
    flash_attention(s, s, s)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 5
    assert _route_counts() == {"wgmma": routes["wgmma"] + 1,
                               "wgmma_tf32": routes["wgmma_tf32"] + 1,
                               "mma_sync": routes["mma_sync"] + 1,
                               "split_kv": routes["split_kv"] + 2}
    n = 1 * 200 * 4 * 128
    for dtype in (torch.bfloat16, torch.float32):
        off = torch.randn(n + 1, device=cuda).to(dtype)[1:].view(
            1, 200, 4, 128)
        with pytest.raises(ValueError, match="q is not 16-byte aligned"):
            flash_attention(off, k.to(dtype), v.to(dtype))
    assert flash_attention.launches == before + 5
    assert _route_counts()["wgmma"] == routes["wgmma"] + 1
    assert _route_counts()["wgmma_tf32"] == routes["wgmma_tf32"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("keys", [512, 4096, 32768])
def test_cuda_flash_attention_bf16_does_not_drift_with_key_count(cuda,
                                                                 keys):
    """K6 in bf16 (the wgmma route) over one sequence of ``keys`` tokens
    at tinyllama's heads (32 q over 4 kv heads of 64, causal): the last
    64 rows' error against float64, over the output's largest |value|,
    within twice the plain version's own, which is its output's bf16
    rounding (1.9-2.6e-3 of the scale on the mma.sync route). O stays in
    the wgmma accumulators across every KV tile."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(keys + 1)
    q, k, v = (torch.randn((1, keys, h, 64), generator=gen, device=cuda)
               .bfloat16() for h in (32, 4, 4))
    r0 = keys - 64
    qg = q[:, r0:].double().reshape(1, 64, 4, 8, 64) * 64 ** -0.5
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double())
    pos = torch.arange(keys, device=cuda)
    sc = sc.masked_fill(pos[r0:, None] < pos[None, :], float("-inf"))
    want = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(sc, dim=-1),
                        v.double()).reshape(1, 64, 32, 64)
    scale = want.abs().max().item()
    routes = _route_counts()
    got = flash_attention(q, k, v, causal=True)[:, r0:].double()
    assert _route_counts()["wgmma"] == routes["wgmma"] + 1
    plain = flash_attention_plain(q[:, r0:], k, v, causal=True,
                                  q_offset=r0).double()
    err = (got - want).abs().max().item() / scale
    plain_err = (plain - want).abs().max().item() / scale
    assert err <= 2 * plain_err, (err, plain_err)


def _tf32_case(cuda, seed, b, sq, skv, hq, hkv, d, dv):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=cuda)
                 for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                               (b, skv, hkv, dv)))


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv,sq,skv,hq,hkv,causal,window", [
    (64, 64, 1000, 1000, 8, 2, True, 0),
    (64, 64, 129, 129, 5, 1, True, 0),
    (64, 64, 1000, 1000, 7, 1, False, 0),
    (64, 64, 129, 1000, 8, 1, False, 0),
    (64, 64, 1000, 65, 4, 4, False, 0),
    (64, 64, 2048, 2048, 4, 1, True, 1024),
    (64, 64, 65, 65, 8, 8, True, 0),
    (64, 64, 1, 129, 4, 1, False, 0),
    (128, 128, 1000, 1000, 8, 2, True, 0),
    (128, 128, 129, 129, 7, 1, True, 0),
    (128, 128, 1000, 1, 4, 1, False, 0),
    (128, 128, 300, 1000, 5, 1, False, 0),
    (128, 128, 1500, 1500, 8, 1, True, 1024),
    (128, 128, 1000, 129, 4, 4, False, 0),
    (128, 128, 63, 200, 4, 4, False, 0),
    (192, 128, 1000, 1000, 4, 4, True, 0),
    (192, 128, 129, 129, 8, 1, True, 0),
    (192, 128, 1000, 700, 4, 1, False, 0),
    (192, 128, 1200, 1200, 4, 4, True, 1024),
    (192, 128, 65, 65, 7, 7, False, 0),
    (192, 128, 1, 63, 4, 4, False, 0),
])
def test_cuda_flash_attention_wgmma_tf32_matches_plain(cuda, d, dv, sq, skv,
                                                       hq, hkv, causal,
                                                       window):
    """The TF32 wgmma kernel (``csrc/flash_attention_sm90_tf32.cu``)
    against the plain version at each of its head-dim pairs, causal, not
    causal and with a window of 1024, GQA groups 1, 4, 5, 7 and 8, Sq and
    Skv of 65, 129 and 1000 and Skv < Sq, within 2e-4. An f32 call of
    more than 64 rows goes to it through ``flash_attention``; one with
    fewer is launched on it directly (the routing sends those to the
    split_kv kernel)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _tf32_case(cuda, sq + skv + d + hq, 2, sq, skv, hq, hkv, d, dv)
    before, routes = flash_attention.launches, _route_counts()
    if fa.flash_attention_route(q.dtype, d, dv, sq) == "wgmma_tf32":
        got = flash_attention(q, k, v, causal=causal, window=window)
    else:
        got = q.new_empty((2, sq, hq, dv))
        fa._launch("wgmma_tf32", q, k, v, got, causal, window, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert _route_counts() == {**routes,
                               "wgmma_tf32": routes["wgmma_tf32"] + 1}
    assert got.dtype == torch.float32 and got.shape == (2, sq, hq, dv)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


#: (dtype, route) of each K6 kernel the offset cases launch
K6_OFFSET_ROUTES = ((torch.bfloat16, "wgmma"), (torch.float32, "wgmma_tf32"),
                    (torch.float32, "mma_sync"))


@pytest.mark.cuda
@pytest.mark.parametrize("q_offset", [0, 37, 3840])
@pytest.mark.parametrize("window", [0, 1024])
@pytest.mark.parametrize("dtype,route", K6_OFFSET_ROUTES,
                         ids=[r for _, r in K6_OFFSET_ROUTES])
def test_cuda_flash_attention_q_offset_matches_plain(cuda, dtype, route,
                                                     window, q_offset):
    """Each K6 route at a query offset: 256 rows of a sequence-parallel
    rank (16 sequences, 16 q heads over 2 KV heads of 128, qwen2.5-3b's
    ``train_4k`` share) at positions ``q_offset ..`` over 4096 keys,
    causal and with a window of 1024, against ``flash_attention_plain(
    q_offset=)``: within 2e-4 in f32, plus one bf16 step in bf16 (phase
    2's tolerances). The wgmma routes take the call through
    ``flash_attention``; ``mma_sync`` (which the routing gives head dims
    16 and 32) is launched directly. Every call is the kernel's:
    the launch is counted on its route."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1000 + q_offset + window)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((16, 256, 16, 128), (16, 4096, 2, 128),
                             (16, 4096, 2, 128)))
    before, routes = flash_attention.launches, _route_counts()
    if route == "mma_sync":
        got = q.new_empty(q.shape)
        fa._launch(route, q, k, v, got, True, window, 128 ** -0.5, q_offset)
    else:
        assert fa.flash_attention_route(dtype, 128, 128, 256) == route
        got = flash_attention(q, k, v, causal=True, window=window,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert _route_counts() == {**routes, route: routes[route] + 1}
    want = flash_attention_plain(q, k, v, causal=True, window=window,
                                 q_offset=q_offset)
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=rel,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,q_offset,window",
                         [row[1:] for row in K6_CUT],
                         ids=[row[0] for row in K6_CUT])
def test_cuda_flash_attention_at_the_moe_cut_shapes(cuda, b, sq, skv, hq,
                                                    hkv, d, dv, q_offset,
                                                    window, dtype):
    """K6 at the cut shapes of the MoE and hybrid families
    (``chip_smoke.K6_CUT``): phi3.5-moe-42b's 32/8 heads of 128 and
    hymba-1.5b's 25/5 of 64 (windowed and global) as the last model
    rank's rows at their offset, and deepseek-v2-lite-16b's one head a
    rank of 192/128, on the bf16 and the f32 wgmma routes, against
    ``flash_attention_plain(q_offset=)`` over slices of the rows (the
    first, a middle and the last 256), within 2e-4, plus one bf16 step in
    bf16."""
    from repro_torch.kernels.flash_attention import flash_attention_route
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sq + hq + d + q_offset)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                             (b, skv, hkv, dv)))
    route = flash_attention_route(dtype, d, dv, sq)
    assert route == ("wgmma" if dtype == torch.bfloat16 else "wgmma_tf32")
    before, routes = flash_attention.launches, _route_counts()
    got = flash_attention(q, k, v, causal=True, window=window,
                          q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert _route_counts() == {**routes, route: routes[route] + 1}
    assert got.dtype == dtype and got.shape == (b, sq, hq, dv)
    rows = {(0, min(sq, 256)), (max(sq // 2 - 128, 0), min(sq // 2 + 128, sq)),
            (max(sq - 256, 0), sq)}
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    for r0, r1 in sorted(rows):
        want = flash_attention_plain(q[:, r0:r1], k, v, causal=True,
                                     window=window, q_offset=q_offset + r0)
        torch.testing.assert_close(got[:, r0:r1].float(), want.float(),
                                   rtol=rel, atol=2e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_q_offset_grads_and_refusal(cuda):
    """Under autograd an offset call's forward is the kernel and its
    gradients autograd's through ``flash_attention_plain(q_offset=)``
    (within 2e-4); a negative offset raises before any launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((2, 100, 8, 64), (2, 400, 2, 64),
                             (2, 400, 2, 64)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention.launches
    out = flash_attention(*leaves, causal=True, q_offset=300)
    assert flash_attention.launches == before + 1
    grads = torch.autograd.grad(out.square().sum(), leaves)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(
        *plain, causal=True, q_offset=300).square().sum(), plain)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, q_offset=-1)
    assert flash_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,window,d,dv", [
    (700, 0, 0, 64, 64), (1000, 300, 64, 64, 64), (1000, 300, 64, 192, 128)])
def test_cuda_flash_attention_wgmma_tf32_rows_without_keys_write_zero(
        cuda, sq, skv, window, d, dv):
    """Rows that see no key write 0 on the TF32 wgmma route: every row
    when there are no keys, and, causal with a window of 64 over 300
    keys, every row from 363 on."""
    q, k, v = _tf32_case(cuda, 4, 2, sq, skv, 8, 2, d, dv)
    routes = _route_counts()
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert _route_counts()["wgmma_tf32"] == routes["wgmma_tf32"] + 1
    first_blind = skv + window - 1 if skv else 0
    assert bool((got[:, first_blind:] == 0).all())
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,sq", [(4369, 15, 65), (4096, 16, 129),
                                     (4369, 15, 64)])
def test_cuda_flash_attention_wgmma_tf32_many_heads(cuda, b, hq, sq):
    """f32 at B * Hq at and past 65535: the TF32 wgmma route's one grid
    dimension (B * Hq * ceil(Sq / 64) blocks) takes 65536 pairs; the
    split_kv route (64 rows) puts (sequence, kv head) pairs on grid.x.
    Checked on the first and last sequences."""
    from repro_torch.kernels.flash_attention import flash_attention_route
    q, k, v = _tf32_case(cuda, b + sq, b, sq, 64, hq, 1, 64, 64)
    route = flash_attention_route(q.dtype, 64, 64, sq)
    assert route == ("wgmma_tf32" if sq > 64 else "split_kv")
    routes = _route_counts()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _route_counts() == {**routes, route: routes[route] + 1}
    for i in (0, b - 1):
        want = flash_attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                     causal=True)
        torch.testing.assert_close(got[i:i + 1], want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_wgmma_tf32_refusal_raises(cuda):
    """A call the TF32 wgmma kernel refuses raises and runs nothing in its
    place: head dims it is not built for (32, 32), launched on it
    directly, and a call whose q is not 16-byte aligned."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _tf32_case(cuda, 6, 1, 200, 200, 4, 2, 32, 32)
    out = q.new_empty((1, 200, 4, 32))
    before, routes = flash_attention.launches, _route_counts()
    with pytest.raises(RuntimeError, match="reconic_flash_attention_sm90_tf32"):
        fa._launch("wgmma_tf32", q, k, v, out, True, 0, 32 ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before
    assert _route_counts() == routes
    q, k, v = _tf32_case(cuda, 7, 1, 200, 200, 4, 2, 64, 64)
    off = torch.randn(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        flash_attention(off, k, v)
    assert flash_attention.launches == before
    assert _route_counts() == routes


@pytest.mark.cuda
@pytest.mark.parametrize("b,skv,hkv,d,dv,words", [
    (8, 512, 16, 192, 128, 8 * 512 * 16 * (192 + 2 * 128)),
    (2, 65, 4, 64, 64, 2 * 65 * 4 * 64 + 2 * 2 * 4 * 64 * 72),
    (1, 0, 1, 128, 128, 0),
])
def test_tf32_scratch_words(cuda, b, skv, hkv, d, dv, words):
    """The TF32 route's scratch, as the kernel library counts it: K's lo
    part, and V transposed with its keys rounded up to a multiple of 8,
    hi and lo; none for head dims it is not built for."""
    from repro_torch.kernels.flash_attention import tf32_scratch_words
    assert tf32_scratch_words(b, skv, hkv, d, dv) == words
    assert tf32_scratch_words(b, skv, hkv, 32, 32) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(64, 64), (192, 128)])
def test_cuda_flash_attention_wgmma_tf32_refuses_short_scratch(cuda, d, dv):
    """The TF32 entry point refuses a scratch one word short of its own
    count (and writes nothing), and takes one of exactly that count."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import tf32_scratch_words
    q, k, v = _tf32_case(cuda, 8, 2, 300, 300, 4, 2, d, dv)
    words = tf32_scratch_words(2, 300, 2, d, dv)
    scratch = torch.zeros(words, device=cuda)
    out = torch.zeros((2, 300, 4, dv), device=cuda)

    def launch(n):
        _build.launch("reconic_flash_attention_sm90_tf32", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), n, 2, 4, 2, 300, 300, d, dv, 1, 0,
                      0, float(d ** -0.5), _build.stream_ptr(cuda))
        torch.cuda.synchronize()

    with pytest.raises(RuntimeError, match="reconic_flash_attention_sm90_tf32"):
        launch(words - 1)
    assert not scratch.any() and not out.any()
    launch(words)
    torch.testing.assert_close(out, flash_attention_plain(q, k, v),
                               rtol=2e-4, atol=2e-4)


#: (b, sq, skv, hq, hkv, d, dv, causal, window, q_offset) of the split_kv
#: route's cases: 1, 3 and 64 rows over 1, 100 and 1000 keys at GQA
#: groups 1, 4 and 8, causal at the last rows (q_offset = Skv - Sq), with
#: a window of 16, not causal, rows past every key's window (no visible
#: key), and one, several and a ragged last split (split_kv_plan)
SPLIT_KV_CASES = [
    (2, 1, 1, 4, 4, 64, 64, True, 0, 0),
    (2, 1, 100, 4, 1, 64, 64, True, 0, 99),
    (1, 1, 1000, 8, 1, 64, 64, True, 0, 999),
    (1, 3, 1000, 4, 1, 64, 64, True, 16, 997),
    (2, 3, 100, 8, 1, 128, 128, False, 0, 0),
    (1, 64, 1000, 4, 1, 64, 64, True, 0, 936),
    (2, 64, 1000, 8, 8, 128, 128, True, 16, 936),
    (1, 3, 1000, 8, 1, 192, 128, True, 0, 997),
    (3, 1, 1000, 5, 1, 192, 128, False, 0, 0),
    (2, 64, 100, 4, 4, 192, 128, True, 16, 36),
    (2, 3, 100, 4, 1, 64, 64, True, 16, 130),
    (1, 64, 1000, 8, 1, 64, 64, True, 16, 1100),
]


#: phase 2's decode shapes: (where, b, sq, skv, hq, hkv, d, dv, causal,
#: window, q_offset)
DECODE_SHAPES = [
    *((row[0], *row[1:], 0) for row in K6_SERVED if row[2] <= 64),
    ("seamless cross decode", 8, 1, 128, 16, 16, 64, 64, False, 0, 0),
    *K6_DECODE,
]


def _split_kv_case(cuda, dtype, seed, b, sq, skv, hq, hkv, d, dv):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=cuda).to(dtype)
                 for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                               (b, skv, hkv, dv)))


def _split_kv_close(got, want):
    rel = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=rel,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,causal,window,q_offset",
                         SPLIT_KV_CASES)
def test_cuda_flash_attention_split_kv_matches_plain(cuda, dtype, b, sq, skv,
                                                     hq, hkv, d, dv, causal,
                                                     window, q_offset):
    """The split_kv kernel (``csrc/flash_attention_splitkv.cu``) against
    the plain version over ``SPLIT_KV_CASES``, through
    ``flash_attention``, within 2e-4 (plus one bf16 step in bf16); each
    call counted once on its route."""
    from repro_torch.kernels.flash_attention import flash_attention_route
    q, k, v = _split_kv_case(cuda, dtype, sq + skv + hq + d + q_offset, b,
                             sq, skv, hq, hkv, d, dv)
    assert flash_attention_route(dtype, d, dv, sq) == "split_kv"
    before, routes = flash_attention.launches, _route_counts()
    got = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert _route_counts() == {**routes, "split_kv": routes["split_kv"] + 1}
    assert got.dtype == dtype and got.shape == (b, sq, hq, dv)
    _split_kv_close(got, flash_attention_plain(
        q, k, v, causal=causal, window=window, q_offset=q_offset))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,causal,window,q_offset",
                         [row[1:] for row in DECODE_SHAPES],
                         ids=[row[0] for row in DECODE_SHAPES])
def test_cuda_flash_attention_split_kv_at_the_decode_shapes(
        cuda, dtype, b, sq, skv, hq, hkv, d, dv, causal, window, q_offset):
    """split_kv at phase 2's decode shapes: seamless's cut cross-attention
    decode (8 x 1 over 8192 frames, one head of 64), its f32 decode at 16
    heads over 128 frames, and ``chip_smoke.K6_DECODE`` (GQA decode over
    a 32768-slot cache at slot 32767), against the plain version."""
    q, k, v = _split_kv_case(cuda, dtype, skv + hq + d, b, sq, skv, hq, hkv,
                             d, dv)
    routes = _route_counts()
    got = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    torch.cuda.synchronize()
    assert _route_counts() == {**routes, "split_kv": routes["split_kv"] + 1}
    _split_kv_close(got, flash_attention_plain(
        q, k, v, causal=causal, window=window, q_offset=q_offset))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("skv,window,q_offset", [(0, 0, 0), (100, 16, 90),
                                                 (1000, 16, 990)])
def test_cuda_flash_attention_split_kv_rows_without_keys_write_zero(
        cuda, dtype, skv, window, q_offset):
    """Rows that see no key write 0 on the split_kv route: every row when
    there are no keys, and, causal with a window of 16, the rows whose
    window starts past the last key (the keys those rows see then fit in
    one tile: one split)."""
    q, k, v = _split_kv_case(cuda, dtype, 11, 2, 40, skv, 8, 2, 64, 64)
    got = flash_attention(q, k, v, causal=True, window=window,
                          q_offset=q_offset)
    torch.cuda.synchronize()
    first_blind = max(0, skv + window - 1 - q_offset) if skv else 0
    assert bool((got[:, first_blind:] == 0).all())
    if skv:
        assert bool((got[:, :first_blind] != 0).any())
    _split_kv_close(got, flash_attention_plain(
        q, k, v, causal=True, window=window, q_offset=q_offset))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cuda_flash_attention_split_kv_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same bits: the splits are
    merged in split order, with no atomics (8 x 1 over 8192 keys, 32 q
    over 4 kv heads of 64: several splits)."""
    from repro_torch.kernels.flash_attention import (split_kv_plan,
                                                     splitkv_wave)
    assert split_kv_plan(8, 32, 4, 1, 8192, False, 0, 0,
                         wave=splitkv_wave(dtype, 64, 64, 1))[0] > 1
    q, k, v = _split_kv_case(cuda, dtype, 12, 8, 1, 8192, 32, 4, 64, 64)
    first = flash_attention(q, k, v, causal=False)
    second = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_flash_attention_split_kv_f32_is_not_tf32(cuda):
    """split_kv in f32 at seamless's cut decode (8 x 1 over 8192 keys, one
    head of 64, not causal) within 1e-5 of a float64 oracle: 3xTF32
    meets it, a single TF32 product does not."""
    q, k, v = _split_kv_case(cuda, torch.float32, 13, 8, 1, 8192, 1, 1, 64,
                             64)
    routes = _route_counts()
    got = flash_attention(q, k, v, causal=False).double()
    assert _route_counts()["split_kv"] == routes["split_kv"] + 1
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double() * 64 ** -0.5, k.double())
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1),
                        v.double())
    err = (got - want).abs().max().item()
    assert err <= 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("keys", [512, 4096, 32768])
def test_cuda_flash_attention_split_kv_does_not_drift_with_key_count(
        cuda, dtype, keys):
    """split_kv over ``keys`` keys at tinyllama's decode (8 x 1 row at slot
    keys - 1, 32 q over 4 kv heads of 64, causal): its error against
    float64, over the output's largest |value|, stays put as the keys
    grow: in bf16 within twice the plain version's own (the output's
    rounding), in f32 within the 1e-5 that tells 3xTF32 from one TF32
    product at every key count (each tile's PV added to O in f32, the
    splits merged in f32; the plain f32 version of one row, a dot of f32
    products, sits far under it)."""
    q, k, v = _split_kv_case(cuda, dtype, keys + 2, 8, 1, keys, 32, 4, 64,
                             64)
    qg = q.double().reshape(8, 1, 4, 8, 64) * 64 ** -0.5
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double())
    want = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(sc, dim=-1),
                        v.double()).reshape(8, 1, 32, 64)
    scale = want.abs().max().item()
    got = flash_attention(q, k, v, causal=True, q_offset=keys - 1).double()
    plain = flash_attention_plain(q, k, v, causal=True,
                                  q_offset=keys - 1).double()
    err = (got - want).abs().max().item() / scale
    plain_err = (plain - want).abs().max().item() / scale
    if dtype == torch.bfloat16:
        assert err <= 2 * plain_err, (err, plain_err)
    else:
        assert err <= 1e-5, (err, plain_err)


@pytest.mark.cuda
def test_cuda_flash_attention_split_kv_refusals(cuda):
    """The split_kv entry point refuses a scratch one word short of its
    own count, a plan that leaves keys out or starts a split past them,
    and head dims it is not built for, writing nothing; a misaligned
    input raises in the wrapper before any launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (split_kv_plan,
                                                     splitkv_scratch_words,
                                                     splitkv_wave)
    q, k, v = _split_kv_case(cuda, torch.bfloat16, 14, 2, 1, 4096, 8, 2, 64,
                             64)
    splits, per = split_kv_plan(2, 8, 2, 1, 4096, False, 0, 0,
                                wave=splitkv_wave(torch.bfloat16, 64, 64, 1))
    words = splitkv_scratch_words(2, 8, 1, 64, splits)
    assert splits > 1 and words == 2 * 8 * splits * (64 + 2)
    scratch = torch.zeros(words, device=cuda)
    out = torch.zeros_like(q)

    def launch(n, splits, per, d=64):
        _build.launch("reconic_flash_attention_splitkv", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), n, 2, 8, 2, 1, 4096, d, d, 0, 0,
                      0, float(64 ** -0.5), 1, splits, per,
                      _build.stream_ptr(cuda))
        torch.cuda.synchronize()

    for args in ((words - 1, splits, per), (words, splits - 1, per),
                 (words, splits + 1, per), (words, splits, per + 1),
                 (words, splits, per, 32)):
        with pytest.raises(RuntimeError,
                           match="reconic_flash_attention_splitkv"):
            launch(*args)
    assert not scratch.any() and not out.any()
    launch(words, splits, per)
    _split_kv_close(out, flash_attention_plain(q, k, v, causal=False))
    before, routes = flash_attention.launches, _route_counts()
    off = torch.randn(q.numel() + 1, device=cuda).bfloat16()[1:]
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        flash_attention(off.view(q.shape), k, v)
    assert flash_attention.launches == before
    assert _route_counts() == routes


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
@pytest.mark.parametrize("slow", [False, True],
                         ids=["zero-state", "slow-seeded"])
@pytest.mark.parametrize("b,s,nh,hd,n,chunk",
                         [row[1:] for row in K7_SERVED],
                         ids=[row[0] for row in K7_SERVED])
def test_cuda_ssd_scan_at_served_shapes(cuda, b, s, nh, hd, n, chunk, slow):
    """K7 in f32 at the shapes the bf16 and train_4k cells give it
    (``chip_smoke.K7_SERVED``: 128 and 16 chunks a sequence) against its plain
    version, y and the final state within 2e-5: as a prefill from fresh
    caches passes it (dt in (0.1, 0.9), a zero state), and with slow
    decays (dt in (0.001, 0.01)) from a seeded state, so that the state
    carried from chunk to chunk counts several chunks later."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(nh + n + slow)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    x, bm, cm = rand(b, s, nh, hd), rand(b, s, 1, n), rand(b, s, 1, n)
    lo, hi = (0.001, 0.01) if slow else (0.1, 0.9)
    dt = torch.empty((b, s, nh), device=cuda).uniform_(lo, hi, generator=gen)
    a = -torch.linspace(1.0, 16.0, nh, device=cuda)
    init = (rand(b, nh, hd, n) if slow
            else torch.zeros((b, nh, hd, n), device=cuda))
    before = ssd_scan.launches
    y, final = ssd_scan(x, dt, a, bm, cm, chunk=chunk, init_state=init,
                        return_final_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want_y, want_f = ssd_scan_plain(x, dt, a, bm, cm, chunk, init)
    torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5)
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
    before, routes = flash_attention.launches, _route_counts()
    out = flash_attention(q, k, v, causal=True, window=window)
    assert flash_attention.launches == before + 1
    _assert_routed(routes, dtype, d, d, s)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,dv,window", [
    (32, 4, 64, 64, 0),             # tinyllama-1.1b
    (25, 5, 64, 64, 1024),          # hymba-1.5b's windowed layers
    (16, 16, 192, 128, 0),          # MLA (deepseek-v2-lite-16b)
])
def test_cuda_flash_attention_blockwise_backward_matches_plain(
        cuda, hq, hkv, d, dv, window, dtype):
    """K6 at 2 x 4096 with the blockwise backward of ``train_4k``
    (``models.layers._attention_blockwise``, chunks of 1024 keys): one
    launch on the route its class takes, the forward and nothing in the
    backward, and the gradients for q, k and v equal autograd's through
    the plain version: f32 within 2e-4, bf16 within one bf16 step of
    each gradient's largest |value| (the scan rounds P to bf16 before PV,
    as the reference does; ``tools/blockwise_bf16_steps.py`` prints each
    gradient's error in steps)."""
    def rand(*shape):
        return torch.from_numpy(RNG.standard_normal(shape).astype(
            np.float32)).to(cuda).to(dtype).requires_grad_()

    q, k, v = rand(2, 4096, hq, d), rand(2, 4096, hkv, d), rand(2, 4096,
                                                               hkv, dv)
    w = torch.from_numpy(RNG.standard_normal((2, 4096, hq, dv)).astype(
        np.float32)).to(cuda).to(dtype)
    backward = functools.partial(_attention_blockwise, q_offset=0,
                                 kv_len=None, chunk=1024)
    before, routes = flash_attention.launches, _route_counts()
    out = flash_attention(q, k, v, causal=True, window=window,
                          backward=backward)
    got = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    assert flash_attention.launches == before + 1
    _assert_routed(routes, dtype, d, dv, 4096)
    ref = flash_attention_plain(q, k, v, causal=True, window=window)
    want = torch.autograd.grad((ref.float() * w.float()).sum(), (q, k, v))
    if dtype == torch.float32:
        for g, e in zip(got, want):
            torch.testing.assert_close(g, e, rtol=2e-4, atol=2e-4)
        return
    for g, e in zip(got, want):
        assert g.dtype == dtype and g.shape == e.shape
        step = 2.0 ** (np.floor(np.log2(float(e.float().abs().max()))) - 7)
        err = float((g.float() - e.float()).abs().max())
        assert err <= step, (err, step)


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
    before, routes = flash_attention.launches, _route_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_routed(routes, dtype, 192, 128, sq)
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
    before, routes = flash_attention.launches, _route_counts()
    out = flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    assert flash_attention.launches == before + 1
    _assert_routed(routes, dtype, 192, 128, 96)
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
    before, routes = flash_attention.launches, _route_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_routed(routes, q.dtype, d, d, sq)
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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-370m"])
def test_cuda_dots_train_step_matches_full(cuda, arch):
    """A 2-layer bf16 train step (remat, 2 x 512) of a K6 model and of a
    K7 model under the ``dots`` remat policy against the same step under
    ``full``: K6's and K7's launches the same (forward and recompute: the
    policy never sees a ctypes launch, so both are recomputed), the loss
    and gradient norm within 1e-4 relative and each gradient leaf within
    one bf16 step of its largest |value| (``chip_smoke.train_step_checks``'
    tolerances)."""
    import dataclasses
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models import init_params
    from repro_torch.models import transformer as T
    from repro_torch.train import init_adam, make_train_step

    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, remat=True,
                       param_dtype="bfloat16")
    params = init_params(cfg, 0, torch.bfloat16, cuda)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in SyntheticPipeline(
        DataConfig(seed=0, vocab_size=cfg.vocab_size, batch=2,
                   seq_len=512)).batch_at(0).items()}
    out = {}
    for policy in ("full", "dots"):
        step = make_train_step(cfg, tcfg)
        step.keep_grads = True
        before = (flash_attention.launches, ssd_scan.launches)
        with T.remat_policy(policy):
            loss, _, _ = step(params, init_adam(params), batch)
        torch.cuda.synchronize()
        out[policy] = (float(loss), float(step.grad_norm),
                       (flash_attention.launches - before[0],
                        ssd_scan.launches - before[1]),
                       [g.float() for g in tree_leaves(step.last_grads)])
    (l0, n0, k0, g0), (l1, n1, k1, g1) = out["full"], out["dots"]
    assert k1 == k0 and k0 == ((2 * cfg.num_layers, 0) if arch ==
                               "tinyllama-1.1b" else (0, 2 * cfg.num_layers))
    assert abs(l1 - l0) <= 1e-4 * abs(l0) and abs(n1 - n0) <= 1e-4 * n0
    step_bf16 = torch.finfo(torch.bfloat16).eps
    for a, b in zip(g1, g0):
        if b.numel():       # mamba2's zero-width FFN, as the reference's
            torch.testing.assert_close(
                a, b, rtol=0, atol=step_bf16 * float(b.abs().max()))


@pytest.mark.cuda
def test_cuda_whole_attention_rows_run_k6_at_the_rank_offset(cuda):
    """hymba-1.5b's attention block (25 q over 5 KV heads of 64, d_model
    1600) as the last rank of a model axis of 3 (a plan's group), which
    divides neither 1600 nor 320 columns: ``wq``, ``wk``, ``wv`` and
    ``wo`` whole on the rank. Over 2 x 384 tokens in bf16 the rank's 128
    rows of q (projected through the whole ``wq`` on those rows alone)
    go to K6 on ``wgmma`` at query offset 256 over K and V projected
    whole, and the rank's rows of the block's output (through the whole
    ``wo``) are within 2e-4 plus one bf16 step of the unsharded
    block's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import PlanMesh
    from repro_torch.models import sharding
    from repro_torch.models.layers import attention_block, init_attention

    cfg = get_config("hymba-1.5b")
    n, b, s = 3, 2, 384
    whole = sharding.whole_leaves(cfg, n)
    assert {f"layers/mixer/attn/{w}" for w in ("wq", "wk", "wv", "wo")} \
        <= set(whole)
    plan = PlanMesh((n,), ("model",), [n - 1])
    tp = sharding.TensorParallel(plan.group(("model",)), False)
    gen = torch.Generator(cuda).manual_seed(5)
    params = init_attention(gen, cfg, torch.bfloat16, cuda, None)
    x = torch.randn((b, s, cfg.d_model), generator=gen,
                    device=cuda).to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device=cuda).expand(b, s)
    launch, logged = fa._launch, []

    def logging(route, *args):
        logged.append((route, int(args[0].shape[1]),
                       int(args[7]) if len(args) > 7 else 0))
        return launch(route, *args)

    fa._launch = logging
    try:
        with torch.no_grad():
            got, _ = attention_block(params, cfg, x, pos, tp=tp)
            want, _ = attention_block(params, cfg, x, pos)
        torch.cuda.synchronize()
    finally:
        fa._launch = launch
    rows = s // n
    assert logged == [("wgmma", rows, (n - 1) * rows), ("wgmma", s, 0)]
    # the plan's gather puts the rank's rows in its own place
    mine = slice((n - 1) * rows, s)
    torch.testing.assert_close(got[:, mine].float(), want[:, mine].float(),
                               rtol=2 ** -7, atol=2e-4)


@pytest.mark.cuda
def test_cuda_mla_rows_prefill_runs_k6_at_the_rank_offset(cuda):
    """An MLA prefill on the "rows" mode: deepseek-v2-lite's MLA head
    dims at a small width, 4 heads on the last rank of a model axis of 8
    (a plan's group), 1024 tokens in bf16. The rank's 128 rows of every
    head (q's 96-column cut, half a head, all-to-all into whole rows)
    go to K6 on ``wgmma`` at query offset 896 over the whole K and V,
    and the kernel's output is within 2e-4 plus one bf16 step of
    ``flash_attention_plain(q_offset=)`` on the same inputs."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import PlanMesh
    from repro_torch.models import init_params, sharding
    from repro_torch.models.layers import mla_block
    from repro_torch.models.transformer import _layer

    base = get_config("deepseek-v2-lite-16b-smoke")
    cfg = dataclasses.replace(base, mla=get_config("deepseek-v2-lite-16b").mla,
                              moe=dataclasses.replace(base.moe,
                                                      num_experts=8))
    n, s = 8, 1024
    plan = PlanMesh((n,), ("model",), [n - 1])
    tp = sharding.TensorParallel(plan.group(("model",)), False)
    params = init_params(cfg, 0, torch.bfloat16, cuda, tp_rank=n - 1,
                         tp_size=n)
    mp = _layer(params["layers"], 0)["mixer"]["mla"]
    x = torch.randn((1, s, cfg.d_model), generator=torch.Generator(
        cuda).manual_seed(5), device=cuda).to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32, device=cuda)[None]
    calls, real = [], ops.attention

    def logged(q, k, v, **kw):
        out = real(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    ops.attention = logged
    try:
        routes = dict(flash_attention.route_launches)
        with torch.no_grad():
            mla_block(mp, cfg, x, pos, tp=tp)
        torch.cuda.synchronize()
    finally:
        ops.attention = real
    (q, k, v, kw, got), = calls
    rows = s // n
    assert kw["q_offset"] == (n - 1) * rows and kw["causal"]
    assert tuple(q.shape) == (1, rows, cfg.num_heads, 192)
    assert tuple(k.shape[1:3]) == (s, cfg.num_heads) and v.shape[-1] == 128
    assert flash_attention.route_launches["wgmma"] == routes["wgmma"] + 1
    want = flash_attention_plain(q, k, v, causal=True,
                                 q_offset=kw["q_offset"])
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2e-4)
