"""The port's kernels against the JAX package's Pallas kernels.

The same numpy inputs (fixed seed) go through the JAX kernel, run in
``interpret=True`` mode as ``test_kernels.py`` runs it, and through the
port's wrapper on CPU tensors, which runs its plain PyTorch version.
Tolerances: K1 quantize, K2 dequantize and K3 parse are bit/byte-exact;
K5 matmul is within ``1e-5 * k / 128`` in f32 (the sums may run in another
order) and ``3e-2`` in bf16, as in ``test_kernels.py``.

``test_torch_cuda.py`` holds each CUDA kernel against its plain version
on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.packet_parser import parse_packets as j_parse
from repro.kernels.quantize_stream import dequantize_stream as j_dequant
from repro.kernels.quantize_stream import quantize_stream as j_quant
from repro.kernels.systolic_mm import systolic_mm as j_mm
from repro_torch.kernels import ops as tops
from repro_torch.kernels.packet_parser import parse_packets
from repro_torch.kernels.quantize_stream import (INV_QMAX,
                                                 dequantize_stream,
                                                 quantize_stream)
from repro_torch.kernels.systolic_mm import systolic_mm

RNG = np.random.default_rng(1234)


def _rows(n, chunk):
    """Random rows of varied magnitude, with one all-zero row."""
    x = (RNG.standard_normal((n, chunk))
         * RNG.uniform(0.01, 100.0, (n, 1))).astype(np.float32)
    x[n // 2] = 0.0
    return x


def _roce_packets(n_pkts):
    pkts = RNG.integers(0, 256, size=(n_pkts, 64)).astype(np.uint8)
    pkts[::2, 12:14] = [0x08, 0x00]      # IPv4
    pkts[::2, 23] = 17                   # UDP
    pkts[::2, 36:38] = [18, 183]         # dport 4791 (RoCEv2)
    pkts[::4, 42] = RNG.integers(0, 20, size=pkts[::4].shape[0])
    return pkts


# ---------------------------------------------------------------------------
# K1 quantize_stream / K2 dequantize_stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,chunk", [(6, 64), (3, 1024)])
def test_quantize_bit_exact_vs_pallas(n, chunk):
    x = _rows(n, chunk)
    jq, js = j_quant(jnp.asarray(x), chunk=chunk, interpret=True)
    tq, ts = quantize_stream(torch.from_numpy(x), chunk=chunk)
    assert tq.dtype == torch.int8 and ts.shape == (n, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_bf16_input_bit_exact_vs_pallas():
    x = _rows(4, 64)
    jq, js = j_quant(jnp.asarray(x, jnp.bfloat16), chunk=64,
                     interpret=True)
    tq, ts = quantize_stream(torch.from_numpy(x).to(torch.bfloat16),
                             chunk=64)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_quantize_nonfinite_row_scale_matches(bad):
    """A row holding ±inf or NaN: the scales match (the max propagates
    NaN); that row's int8 codes are implementation-defined in both
    frameworks and are not compared, the other rows' are."""
    x = _rows(4, 64)
    x[1, 5] = bad
    jq, js = j_quant(jnp.asarray(x), chunk=64, interpret=True)
    tq, ts = quantize_stream(torch.from_numpy(x), chunk=64)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    keep = [0, 2, 3]
    np.testing.assert_array_equal(tq.numpy()[keep], np.asarray(jq)[keep])


def test_inv_qmax_is_the_reference_constant():
    from repro.kernels.quantize_stream import INV_QMAX as J_INV_QMAX
    assert INV_QMAX == J_INV_QMAX


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [64, 1024])
def test_dequantize_bit_exact_vs_pallas(out_dtype, chunk):
    q = RNG.integers(-127, 128, size=(4, chunk)).astype(np.int8)
    s = RNG.uniform(1e-3, 10.0, (4, 1)).astype(np.float32)
    jout = j_dequant(jnp.asarray(q), jnp.asarray(s),
                     out_dtype=getattr(jnp, out_dtype), interpret=True)
    tout = dequantize_stream(torch.from_numpy(q), torch.from_numpy(s),
                             out_dtype=getattr(torch, out_dtype))
    np.testing.assert_array_equal(
        tout.to(torch.float32).numpy(),
        np.asarray(jout.astype(jnp.float32)))


def test_compress_decompress_vs_jax_ops():
    x = RNG.standard_normal(777).astype(np.float32)
    jq, js, jn = jops.compress(jnp.asarray(x), chunk=64)
    tq, ts, tn = tops.compress(torch.from_numpy(x), chunk=64)
    assert tn == jn == 777
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jback = jops.decompress(jq, js, (777,))
    tback = tops.decompress(tq, ts, (777,))
    assert tuple(tback.shape) == (777,)
    np.testing.assert_array_equal(tback.numpy(), np.asarray(jback))


# ---------------------------------------------------------------------------
# K3 parse_packets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "roce"])
def test_parse_packets_byte_exact_vs_pallas(kind):
    n = 64
    pkts = (RNG.integers(0, 256, size=(n, 64)).astype(np.uint8)
            if kind == "random" else _roce_packets(n))
    want = np.asarray(j_parse(jnp.asarray(pkts), block_p=n, interpret=True))
    got = parse_packets(torch.from_numpy(pkts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.classify_packets(torch.from_numpy(pkts)).numpy(), want)


def test_parse_packets_any_n():
    """No pow2/block padding: a ragged batch parses row for row."""
    pkts = _roce_packets(13)
    full = parse_packets(torch.from_numpy(pkts))
    assert tuple(full.shape) == (13, 4)
    np.testing.assert_array_equal(
        full[:5].numpy(), parse_packets(torch.from_numpy(pkts[:5])).numpy())


# ---------------------------------------------------------------------------
# K5 systolic_mm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 384),
                                   (128, 512, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_systolic_mm_vs_pallas(m, k, n, dtype):
    x = RNG.standard_normal((m, k)).astype(np.float32)
    y = RNG.standard_normal((k, n)).astype(np.float32)
    want = j_mm(jnp.asarray(x, getattr(jnp, dtype)),
                jnp.asarray(y, getattr(jnp, dtype)), interpret=True)
    got = systolic_mm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(y).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 * (k / 128) if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n", [(50, 70, 30), (1, 128, 5)])
def test_matmul_unaligned_vs_jax_ops(m, k, n):
    x = RNG.standard_normal((m, k)).astype(np.float32)
    y = RNG.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(y)))
    got = tops.matmul(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# wrappers: no fallback, counters
# ---------------------------------------------------------------------------

def test_cpu_path_does_not_count_launches():
    before = (quantize_stream.launches, dequantize_stream.launches,
              parse_packets.launches, systolic_mm.launches)
    q, s = quantize_stream(torch.ones((2, 64)), chunk=64)
    dequantize_stream(q, s)
    parse_packets(torch.zeros((2, 64), dtype=torch.uint8))
    systolic_mm(torch.ones((2, 3)), torch.ones((3, 2)))
    assert (quantize_stream.launches, dequantize_stream.launches,
            parse_packets.launches, systolic_mm.launches) == before


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel path, which
    raises for anything but a CUDA tensor — it never runs the plain
    version instead."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        quantize_stream(torch.empty((2, 64), device=meta), chunk=64)
    with pytest.raises(ValueError, match="CUDA"):
        parse_packets(torch.empty((2, 64), dtype=torch.uint8, device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        systolic_mm(torch.empty((2, 3), device=meta),
                    torch.empty((3, 2), device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_stream(torch.empty((2, 64), dtype=torch.int8,
                                      device=meta),
                          torch.empty((2, 1), device=meta))


def test_wrappers_reject_bad_shapes_and_dtypes():
    with pytest.raises(ValueError):
        quantize_stream(torch.ones((2, 32)), chunk=64)
    with pytest.raises(TypeError):
        parse_packets(torch.zeros((2, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        systolic_mm(torch.ones((2, 3)), torch.ones((4, 2)))
