"""The numerics of K7's tensor-core route, emulated in PyTorch on the CPU
and held against the JAX reference.

K7 (``csrc/ssd_scan.cu``) runs the SSD scan as five passes: the in-chunk
cumsum (f32, in order), C.B^T once per (sequence, chunk), each chunk's
state increment ``sum_j exp(seg_end - cum_j) dt_j x_j B_j^T``, the state
passed from chunk to chunk, and each chunk's outputs ``y_i = sum_{j<=i}
w_ij x_j + exp(cum_i) C_i . S_prev``. Three of its four products (the
state increment, w.x and C.S_prev) run on the tensor cores as 3xTF32:
``x_hi = tf32_rna(x)``, ``x_lo = tf32_rna(x - x_hi)`` and ``a.b ~
a_lo.b_hi + a_hi.b_lo + a_hi.b_hi``. A bf16 x is exact in TF32, so its
``x_lo`` is 0 and the products with x as an operand drop one term.
C.B^T runs on the FP64 tensor cores, where f32 inputs multiply exactly
and the sum keeps 53 bits: the exact product rounded once to f32.

The emulation runs each product as a chain of ``mma`` calls
(``_mma_chain`` of ``tests/test_torch_tc_numerics.py``: k in chunks of
8, each chunk's products exact in float64, added to an f32 accumulator
with one rounding to nearest), through the five passes; the elementwise
f32 steps between the products are the kernel's. The tensor cores round
an accumulation toward zero, so the kernel sums each k-step's three
products in a fresh accumulator (rounded toward zero once, relative to
the step's sum) and adds it to the running sum with round-to-nearest:
its running sum rounds as the emulation's does. Tolerances: 2e-5 against
``repro.models.ssm._ssd_chunked`` and the Pallas kernel (the reference's
own), and 2e-5 relative to ``1 + |y|`` against a float64 oracle (the
plain version in float64 on the f32 in-order cumsum, from which the
plain f32 version itself lies about as far as the emulated route), which
the GPU test ``test_cuda_ssd_scan_f32_is_not_tf32`` holds the kernel to:
the route meets it and a single TF32 product, in any one of the four
products, misses it by two orders of magnitude, so that test tells the
routes apart.

These tests check the arithmetic of the kernel's design, emulated here,
and no code of ``repro_torch`` but the plain version's float64 mode: the
kernel itself is held by the GPU tests of ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as JSSM
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels.ssd_scan import (NEG_INF, _cumsum_in_order,
                                          ssd_scan_plain)
from test_torch_tc_numerics import _mma_chain, tf32_rna

TOL = 2e-5
ORACLE_TOL = 2e-5
PRODUCTS = ("cb", "state", "wx", "cs")


def _mm(a, b, route):
    """``a @ b`` as the kernel's mma chain: "3xtf32", "f64" (exact, then
    rounded to f32 once), or "tf32" (one TF32 product, which the kernel
    does not run)."""
    if route == "f64":
        return (a.double() @ b.double()).float()
    ah, bh = tf32_rna(a), tf32_rna(b)
    if route == "tf32":
        return _mma_chain([(ah, bh)], 8)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return _mma_chain([(al, bh), (ah, bl), (ah, bh)], 8)


def scan_emulated(x, dt, a, bm, cm, chunk, init=None, single=(),
                  cb_route="f64"):
    """K7's five passes on f32 CPU tensors (x may hold bf16 values): x
    (B, S, nh, hd), dt (B, S, nh), a (nh,), bm/cm (B, S, 1, N), init
    (B, nh, hd, N) or None. ``single`` names the products run as one
    TF32 product instead of the kernel's route; ``cb_route`` is C.B^T's.
    Returns (y, final state), f32."""
    route = {p: "tf32" if p in single else "3xtf32" for p in PRODUCTS}
    if "cb" not in single:
        route["cb"] = cb_route
    b, s, nh, hd = x.shape
    n = bm.shape[-1]
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, nh, hd)
    dtc = dt.reshape(b, nc, chunk, nh)
    bc = bm.reshape(b, nc, chunk, n)
    cc = cm.reshape(b, nc, chunk, n)
    # 1. cum, exp(cum) and exp(seg_end - cum) * dt, f32 elementwise
    cum = _cumsum_in_order(dtc * a)
    seg_end = cum[:, :, -1]
    wst = torch.exp(seg_end[:, :, None] - cum) * dtc
    # 2. C.B^T once per (sequence, chunk)
    cb = _mm(cc, bc.transpose(-1, -2).contiguous(), route["cb"])
    # 3. the state increment: x^T (hd x L) times wst_j * B_j (L x N)
    bw = wst.permute(0, 1, 3, 2)[..., None] * bc[:, :, None]
    inc = _mm(xc.permute(0, 1, 3, 4, 2).contiguous(), bw, route["state"])
    # 4. the state before each chunk, f32 elementwise
    carry = torch.zeros((b, nh, hd, n)) if init is None else init
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(seg_end[:, c])[..., None, None] + inc[:, c]
    prev = torch.stack(prev, 1)
    # 5. w (masked before exp), w.x and C.S_prev
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    rel = torch.where(tri[None, None, :, :, None], rel,
                      torch.tensor(NEG_INF))
    w = cb[..., None] * torch.exp(rel) * dtc[:, :, None, :, :]
    y_intra = _mm(w.permute(0, 1, 4, 2, 3).contiguous(),
                  xc.permute(0, 1, 3, 2, 4).contiguous(), route["wx"])
    y_inter = _mm(cc[:, :, None].expand(b, nc, nh, chunk, n).contiguous(),
                  prev.transpose(-1, -2).contiguous(), route["cs"])
    y = y_intra + torch.exp(cum).permute(0, 1, 3, 2)[..., None] * y_inter
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, nh, hd), carry


def _inputs(seed, b, s, nh, hd, n, seeded, grid_dt=True, dt_hi=0.9):
    """Model-like inputs from a numpy seed: x, B, C and the initial state
    standard normal, the model's a = -linspace(1, 16, nh). With
    ``grid_dt``, dt lies on a grid of 1/64 in (0.1, ``dt_hi``) and a
    (4 heads) is integral, so every partial sum of dt * a is exact in f32
    and the JAX package's cumsum, summed in another order, gives the same
    cum: the comparison is then on the products, not on the rounding of
    |cum| ~ 3000. Otherwise dt is uniform in (0.1, 0.9)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, nh, hd)).astype(f)
    if grid_dt:
        dt = (rng.integers(7, int(dt_hi * 64) + 1, (b, s, nh)) / 64.0
              ).astype(f)
    else:
        dt = rng.uniform(0.1, 0.9, (b, s, nh)).astype(f)
    a = -np.linspace(1.0, 16.0, nh).astype(f)
    bm, cm = (rng.standard_normal((b, s, 1, n)).astype(f) for _ in "bc")
    init = rng.standard_normal((b, nh, hd, n)).astype(f) if seeded else None
    return x, dt, a, bm, cm, init


def _t(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _rel_err(got, want):
    """max |got - want| / (1 + |want|): the error that assert_close with
    rtol == atol weighs."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (1.0 + np.abs(want))).max())


# (nh, hd, n, chunk, s): mamba2-370m's heads, d_state and chunk over 2 x
# 512 tokens with 4 heads; hymba-1.5b's d_state 16
SHAPES = {"mamba2": (4, 64, 128, 256, 512), "hymba": (4, 64, 16, 256, 512)}


@pytest.mark.parametrize("seeded", [True, False])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_emulated_route_matches_reference(shape, seeded):
    """The route through the five passes against ``_ssd_chunked`` and,
    from a zero state, the Pallas kernel in interpret mode, within 2e-5."""
    nh, hd, n, chunk, s = SHAPES[shape]
    x, dt, a, bm, cm, init = _inputs(3 + seeded, 2, s, nh, hd, n, seeded)
    y, f = scan_emulated(*_t(x, dt, a, bm, cm), chunk,
                         None if init is None else _t(init)[0])
    args = [jnp.asarray(t) for t in (x, dt, a, bm, cm)]
    want_y, want_f = JSSM._ssd_chunked(
        *args, chunk, init_state=None if init is None else jnp.asarray(init))
    assert _rel_err(y.numpy(), want_y) <= TOL
    assert _rel_err(f.numpy(), want_f) <= TOL
    if not seeded:
        pallas_y = jax_ssd_scan(*args, chunk=chunk, interpret=True)
        assert _rel_err(y.numpy(), pallas_y) <= TOL


@pytest.mark.parametrize("chunk,s", [(48, 144), (12, 36)])
def test_emulated_route_ragged_chunks(chunk, s):
    """Chunks that are not a multiple of the kernel's 64-row tiles, three
    of them, seeded: the route against ``_ssd_chunked`` within 2e-5."""
    x, dt, a, bm, cm, init = _inputs(chunk, 2, s, 4, 32, 32, True)
    y, f = scan_emulated(*_t(x, dt, a, bm, cm), chunk, _t(init)[0])
    want_y, want_f = JSSM._ssd_chunked(
        *[jnp.asarray(t) for t in (x, dt, a, bm, cm)], chunk,
        init_state=jnp.asarray(init))
    assert _rel_err(y.numpy(), want_y) <= TOL
    assert _rel_err(f.numpy(), want_f) <= TOL


def test_emulated_route_underflow_range():
    """The model's decay range with dt up to 4 over 64-long chunks:
    exp(cum) underflows to 0 (through the subnormals) inside a chunk, and
    the route still matches the reference and stays finite."""
    x, dt, a, bm, cm, _ = _inputs(8, 1, 128, 4, 16, 16, False, dt_hi=4.0)
    cum = np.cumsum(dt[0, :64] * a, axis=0)
    assert (np.exp(cum) == 0).any()
    y, f = scan_emulated(*_t(x, dt, a, bm, cm), 64)
    want_y, want_f = JSSM._ssd_chunked(
        *[jnp.asarray(t) for t in (x, dt, a, bm, cm)], 64)
    assert torch.isfinite(y).all() and torch.isfinite(f).all()
    assert _rel_err(y.numpy(), want_y) <= TOL
    assert _rel_err(f.numpy(), want_f) <= TOL


ORACLE_SEEDS = (11, 21, 31)


def oracle_error(seed, single=()):
    """At the reduced mamba2 shape with model-like dt (not on a grid: the
    oracle takes the f32 in-order cum), seeded: the emulated route's
    largest error against the float64 oracle over y and the final state,
    with the products in ``single`` as one TF32 product each."""
    nh, hd, n, chunk, s = SHAPES["mamba2"]
    x, dt, a, bm, cm, init = _t(*_inputs(seed, 2, s, nh, hd, n, True,
                                         grid_dt=False))
    want_y, want_f = ssd_scan_plain(x, dt, a, bm, cm, chunk, init,
                                    dtype=torch.float64)
    y, f = scan_emulated(x, dt, a, bm[:, :, 0], cm[:, :, 0], chunk, init,
                         single)
    return max(_rel_err(y, want_y), _rel_err(f, want_f))


@pytest.mark.parametrize("seed", ORACLE_SEEDS)
@pytest.mark.parametrize("single", [(), *((p,) for p in PRODUCTS)])
def test_f64_oracle_tells_3xtf32_from_single_tf32(single, seed):
    """The route stays within 2e-5 of the float64 oracle; one TF32 product
    in any one of the four products puts y or the final state over it
    (``oracle_error``), for each of three seeds."""
    err = oracle_error(seed, single)
    if single:
        assert err > ORACLE_TOL, err
    else:
        assert err <= ORACLE_TOL, err


def test_bf16_x_takes_two_products():
    """A bf16 x is exact in TF32: its low half is 0, so the products with
    x as an operand need two TF32 products, and the route on bf16 values
    meets the oracle's 2e-5 as in f32."""
    nh, hd, n, chunk, s = SHAPES["mamba2"]
    x, dt, a, bm, cm, init = _t(*_inputs(12, 2, s, nh, hd, n, True,
                                         grid_dt=False))
    x = x.bfloat16().float()
    assert torch.equal(tf32_rna(x), x)
    assert not tf32_rna(x - tf32_rna(x)).any()
    want_y, want_f = ssd_scan_plain(x, dt, a, bm, cm, chunk, init,
                                    dtype=torch.float64)
    y, f = scan_emulated(x, dt, a, bm[:, :, 0], cm[:, :, 0], chunk, init)
    assert max(_rel_err(y, want_y), _rel_err(f, want_f)) <= ORACLE_TOL


def test_cb_in_f64_keeps_the_plain_versions_distance():
    """Why C.B^T runs in f64: the plain f32 version's own C.B^T (a dot
    product over N = 128) is what moves it from the oracle, and with C.B^T
    exact the route lies no farther from the plain version than the plain
    version lies from the oracle (the distance the 2e-5 contract has to
    hold), where 3xTF32 C.B^T, though within 2e-5 of the oracle, adds its
    own error to that distance."""
    nh, hd, n, chunk, s = SHAPES["mamba2"]
    x, dt, a, bm, cm, init = _t(*_inputs(11, 2, s, nh, hd, n, True,
                                         grid_dt=False))
    want_y, _ = ssd_scan_plain(x, dt, a, bm, cm, chunk, init,
                               dtype=torch.float64)
    plain_y, _ = ssd_scan_plain(x, dt, a, bm, cm, chunk, init)
    plain_err = _rel_err(plain_y, want_y)
    f64_y, _ = scan_emulated(x, dt, a, bm, cm, chunk, init)
    tf32_y, _ = scan_emulated(x, dt, a, bm, cm, chunk, init,
                              cb_route="3xtf32")
    assert _rel_err(tf32_y, want_y) <= ORACLE_TOL
    assert _rel_err(f64_y, plain_y) <= 1.05 * plain_err
    assert _rel_err(tf32_y, plain_y) > 1.2 * plain_err


@pytest.mark.parametrize("seeded", [True, False])
def test_plain_float64_mode_keeps_the_f32_cumsum(seeded):
    """``ssd_scan_plain(dtype=torch.float64)`` returns float64 within 2e-5
    of the f32 version, and decays the state by exp of the f32 cumsum
    summed in order: with x = 0 over one chunk the final state is exactly
    ``init * exp(float64(cum_f32[-1]))``."""
    x, dt, a, bm, cm, init = _t(*_inputs(13, 2, 96, 3, 16, 32, seeded,
                                         grid_dt=False))
    y64, f64 = ssd_scan_plain(x, dt, a, bm, cm, 48, init,
                              dtype=torch.float64)
    y32, f32 = ssd_scan_plain(x, dt, a, bm, cm, 48, init)
    assert y64.dtype == f64.dtype == torch.float64
    assert y32.dtype == f32.dtype == torch.float32
    assert _rel_err(y32, y64) <= TOL and _rel_err(f32, f64) <= TOL
    if seeded:
        _, fz = ssd_scan_plain(torch.zeros_like(x[:, :48]), dt[:, :48], a,
                               bm[:, :48], cm[:, :48], 48, init,
                               dtype=torch.float64)
        seg_end = _cumsum_in_order((dt[:, :48] * a)[:, None])[:, 0, -1]
        assert seg_end.dtype == torch.float32
        want = init.double() * torch.exp(seg_end.double())[..., None, None]
        assert torch.equal(fz, want)


if __name__ == "__main__":
    # The readings the oracle bound is set from: for each seed, the
    # route's error and each single-TF32 variant's, at the reduced shape.
    # Run: PYTHONPATH=src python tests/test_torch_ssd_numerics.py
    for seed in ORACLE_SEEDS:
        print(f"seed {seed}: 3xtf32 {oracle_error(seed):.4g} " + " ".join(
            f"tf32 {p} {oracle_error(seed, (p,)):.4g}" for p in PRODUCTS))
