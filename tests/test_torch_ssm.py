"""The port's SSM and hybrid serving path against the JAX package, on the
CPU: K7 ``ssd_scan`` (its plain version), ``models/ssm.py``, the SSM and
hybrid-heads branches of ``models/transformer.py``, the serve steps, and
the handoff of SSM caches over the engine.

Inputs come from numpy seeds; model weights are the JAX package's
(``repro.models.init_params``) carried over by ``params_from_jax``.
Tolerances, each the reference's own:

- the scan within 2e-5 in f32 and 6e-2 in bf16 (``tests/test_kernels.py``
  SSD section; the einsums sum in another order), final state included;
- block outputs, logits, and prefill + decode against the full forward
  within 5e-5 (``tests/test_models.py``'s prefill/decode bound);
- greedy tokens, cache dtypes, handoff pages, CQEs and the ``kv_serve``
  ledger exactly equal.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
import repro.models.ssm as JSSM
import repro.serve as JS
from _torch_sides import TORCH, _np, run_both, snapshot
from repro.configs.registry import get_config as jax_config
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.configs.registry import get_config
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.launch.serve import run
from repro_torch.models import (forward, init_caches, init_params,
                                params_from_jax)
from repro_torch.models import ssm as TSSM
from repro_torch.serve import decode_step, greedy_generate, prefill_step

ARCHS = ["tiny-ssm", "mamba2-370m-smoke", "hymba-1.5b-smoke"]
TOL = 5e-5
SCAN_TOL = {np.float32: 2e-5, "bf16": 6e-2}
PE = 64           # handoff page elems (one pow2 bucket)


def _scan_inputs(seed, b, s, nh, hd, n, g=1, a_range=(0.5, 2.0),
                 dt_range=(0.1, 0.9)):
    """The reference test's distributions: x, B, C standard normal, dt
    uniform, a negative uniform; f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, s, nh, hd)).astype(f),
            rng.uniform(*dt_range, (b, s, nh)).astype(f),
            -rng.uniform(*a_range, (nh,)).astype(f),
            rng.standard_normal((b, s, g, n)).astype(f),
            rng.standard_normal((b, s, g, n)).astype(f))


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# K7 ssd_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(32, 16), (64, 16), (48, 8), (36, 12)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_scan_matches_jax_kernel(s, chunk, dtype):
    """The reference's grid (and a chunk that is no power of two): the
    port's wrapper on CPU tensors against the Pallas kernel in interpret
    mode, both held to the oracle as ``tests/test_kernels.py`` does."""
    x, dt, a, bm, cm = _scan_inputs(s, 2, s, 4, 16, 32)
    if dtype == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    tol = SCAN_TOL["bf16" if dtype == "bf16" else np.float32]
    want = jax_ssd_scan(jx, jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm),
                        jnp.asarray(cm), chunk=chunk, interpret=True)
    got = ssd_scan(tx, *_t(dt, a, bm, cm), chunk=chunk)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got.float().numpy(), np.asarray(want, np.float32), tol)
    oracle, _ = JSSM._ssd_chunked(jx.astype(jnp.float32), jnp.asarray(dt),
                                  jnp.asarray(a), jnp.asarray(bm),
                                  jnp.asarray(cm), chunk)
    _close(got.float().numpy(), np.asarray(oracle), tol)


@pytest.mark.parametrize("s,chunk,g,seeded", [
    (32, 16, 1, False), (32, 16, 1, True), (48, 12, 1, True),
    (48, 8, 2, False), (48, 8, 2, True), (24, 24, 4, True)])
def test_ssd_scan_plain_matches_ssd_chunked(s, chunk, g, seeded):
    """``ssd_scan_plain``'s (y, final) against ``_ssd_chunked``'s, with and
    without an initial state, n_groups 1, 2 and 4."""
    x, dt, a, bm, cm = _scan_inputs(100 + s + g, 2, s, 4, 16, 32, g=g)
    init = (np.random.default_rng(7).standard_normal((2, 4, 16, 32))
            .astype(np.float32) if seeded else None)
    want_y, want_f = JSSM._ssd_chunked(
        *map(jnp.asarray, (x, dt, a, bm, cm)), chunk,
        init_state=None if init is None else jnp.asarray(init))
    got_y, got_f = ssd_scan_plain(*_t(x, dt, a, bm, cm), chunk,
                                  None if init is None else _t(init)[0])
    assert got_f.dtype == torch.float32 and got_f.shape == (2, 4, 16, 32)
    _close(got_y.numpy(), np.asarray(want_y), 2e-5)
    _close(got_f.numpy(), np.asarray(want_f), 2e-5)
    y2, f2 = ssd_scan(*_t(x, dt, a, bm, cm), chunk=chunk,
                      init_state=None if init is None else _t(init)[0],
                      return_final_state=True)
    assert torch.equal(y2, got_y) and torch.equal(f2, got_f)


@pytest.mark.parametrize("chunk", [8, 12])
def test_ssd_scan_halves_chain_through_the_state(chunk):
    """Scanning the first half, then the second seeded with the first's
    final state, gives the whole scan's outputs and final state."""
    x, dt, a, bm, cm = _t(*_scan_inputs(chunk, 2, 48, 3, 16, 16))
    y, f = ssd_scan(x, dt, a, bm, cm, chunk=chunk, return_final_state=True)
    y1, f1 = ssd_scan(x[:, :24], dt[:, :24], a, bm[:, :24], cm[:, :24],
                      chunk=chunk, return_final_state=True)
    y2, f2 = ssd_scan(x[:, 24:], dt[:, 24:], a, bm[:, 24:], cm[:, 24:],
                      chunk=chunk, init_state=f1, return_final_state=True)
    _close(torch.cat([y1, y2], 1).numpy(), y.numpy(), 2e-5)
    _close(f2.numpy(), f.numpy(), 2e-5)


def test_ssd_scan_underflows_where_the_reference_does():
    """The model's own decay range (a = -linspace(1, 16)) with dt up to 4
    over a 64-long chunk: exp(cum) underflows to 0 inside the chunk, and
    the port still matches the reference and stays finite. dt lies on a
    grid of quarters, so every partial sum of dt * a is exact in f32 and
    the two packages' cumsums (summed in other orders) agree: the check is
    on where exp underflows, not on the rounding of |cum| ~ 2000."""
    nh = 16
    x, _, _, bm, cm = _scan_inputs(3, 1, 128, nh, 16, 16)
    dt = (np.random.default_rng(8).integers(2, 17, (1, 128, nh)) / 4.0
          ).astype(np.float32)
    a = -np.linspace(1.0, 16.0, nh).astype(np.float32)
    cum = np.cumsum(dt[0, :64] * a, axis=0)
    assert (np.exp(cum) == 0).any()           # the regime is reached
    want_y, want_f = JSSM._ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)),
                                       64)
    got_y, got_f = ssd_scan(*_t(x, dt, a, bm, cm), chunk=64,
                            return_final_state=True)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_f).all()
    _close(got_y.numpy(), np.asarray(want_y), 2e-5)
    _close(got_f.numpy(), np.asarray(want_f), 2e-5)


def test_ssd_scan_bad_arguments_raise():
    x, dt, a, bm, cm = _t(*_scan_inputs(0, 1, 24, 2, 16, 16))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(x, dt, a, bm, cm, chunk=16)
    with pytest.raises(ValueError, match="dt must be"):
        ssd_scan(x, dt[..., :1], a, bm, cm, chunk=8)
    with pytest.raises(ValueError, match="init_state"):
        ssd_scan(x, dt, a, bm, cm, chunk=8,
                 init_state=torch.zeros((1, 2, 16, 8)))
    with pytest.raises(TypeError, match="dtype"):
        ssd_scan(x.to(torch.float16), dt, a, bm, cm, chunk=8)


# ---------------------------------------------------------------------------
# models/ssm.py
# ---------------------------------------------------------------------------

def _pair(arch):
    jc, tc = jax_config(arch), get_config(arch)
    params = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jc, tc, params, tp


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


@pytest.mark.parametrize("state", [False, True])
def test_causal_conv_matches_jax(state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if state else None
    want_y, want_s = JSSM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                       None if st is None else
                                       jnp.asarray(st))
    got_y, got_s = TSSM._causal_conv(*_t(x, w),
                                     None if st is None else _t(st)[0])
    _close(got_y.numpy(), np.asarray(want_y), 1e-6)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("route", ["no_cache", "prefill", "decode"])
def test_ssm_block_routes_match_jax(route):
    """The three routes of ``ssm_block`` (chunked scan without caches,
    scan seeded from a cached state, recurrent step) on one layer of
    mamba2-370m-smoke, outputs and new caches against JAX's."""
    jc, tc, jp, tp = _pair("mamba2-370m-smoke")
    jl, tl = _layer0(jp["layers"]["mixer"]["ssm"]), _layer0(
        tp["layers"]["mixer"]["ssm"])
    rng = np.random.default_rng(11)
    s = 1 if route == "decode" else 32
    x = rng.standard_normal((2, s, tc.d_model)).astype(np.float32)
    jcache = tcache = None
    if route != "no_cache":
        c = _layer0(JM.init_caches(jc, 2, 8, jnp.float32)["scan"])
        c = {"conv": rng.standard_normal(c["conv"].shape).astype(np.float32),
             "ssm": rng.standard_normal(c["ssm"].shape).astype(np.float32)}
        jcache = {k: jnp.asarray(v) for k, v in c.items()}
        tcache = {k: torch.from_numpy(v.copy()) for k, v in c.items()}
    want, jnew = JSSM.ssm_block(jl, jc, jnp.asarray(x), cache=jcache)
    got, tnew = TSSM.ssm_block(tl, tc, torch.from_numpy(x), cache=tcache)
    _close(got.numpy(), np.asarray(want), TOL)
    if route != "no_cache":
        assert tnew is tcache                     # written in place
        for key in ("conv", "ssm"):
            _close(tnew[key].numpy(), np.asarray(jnew[key]), TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    jc, tc, jp, tp = _pair(arch)
    tok = _tokens(jc, 2, 32)
    want, _, _ = JM.forward(jp, jc, {"tokens": jnp.asarray(tok)})
    got, caches, aux = forward(tp, tc, {"tokens": torch.from_numpy(tok)})
    assert caches is None and float(aux) == 0.0
    assert got.shape == (2, 32, tc.padded_vocab())
    _close(got.numpy(), np.asarray(want), TOL)


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_paths(tree[k], path + (k,))]
    return [(path, tree)]


def _assert_caches_equal_jax(got, want):
    """Every cache leaf within 5e-5 of JAX's, dtypes equal. A bf16 leaf
    may also sit one bf16 step (2^-7 relative) away: two f32 values 1e-7
    apart can round to neighbouring bf16 values."""
    g, w = _leaves_with_paths(got), _leaves_with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, gl), (_, wl) in zip(g, w):
        assert str(gl.dtype).split(".")[-1] == str(wl.dtype), path
        rtol = 2.0 ** -7 if gl.dtype == torch.bfloat16 else TOL
        np.testing.assert_allclose(gl.float().numpy(),
                                   np.asarray(wl, np.float32), rtol=rtol,
                                   atol=TOL, err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """Prefill 16 tokens, then decode 4 teacher-forced: every step's
    logits equal the full forward's at that position within 5e-5, the
    port's steps equal JAX's, and so do the caches after each step. The
    forward runs 32 tokens: the scan takes whole chunks (S % 16 == 0),
    and causality makes positions 16-19 of it the ones to compare."""
    jc, tc, jp, tp = _pair(arch)
    tok = _tokens(tc, 2, 32, seed=1)
    toks = torch.from_numpy(tok)
    full, _, _ = forward(tp, tc, {"tokens": toks})
    caches = init_caches(tc, 2, 24, torch.float32, device="cpu")
    lg, caches = prefill_step(tp, tc, {"tokens": toks[:, :16]}, caches)
    jcache = JM.init_caches(jc, 2, 24, jnp.float32)
    jlg, jcache = JS.prefill_step(jp, jc, {"tokens": jnp.asarray(tok[:, :16])},
                                  jcache)
    errs = [float((lg[:, -1] - full[:, 15]).abs().max())]
    _close(lg.numpy(), np.asarray(jlg), TOL)
    _assert_caches_equal_jax(caches, jcache)
    for i in range(16, 20):
        lg, caches = decode_step(tp, tc, toks[:, i:i + 1], caches, i)
        jlg, jcache = JS.decode_step(jp, jc, jnp.asarray(tok[:, i:i + 1]),
                                     jcache, jnp.int32(i))
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
        _close(lg.numpy(), np.asarray(jlg), TOL)
    assert max(errs) < TOL, f"{arch}: decode mismatch {errs}"
    _assert_caches_equal_jax(caches, jcache)


@pytest.mark.parametrize("arch", ["tiny-ssm", "hymba-1.5b-smoke"])
def test_bf16_caches_take_jax_dtypes(arch):
    """Caches made in bf16 (the reference's default) under f32 weights:
    after a step every leaf has the dtype JAX's has — the conv buffer the
    activations' f32, the state f32, attention K/V bf16 — and the values
    and logits agree."""
    jc, tc, jp, tp = _pair(arch)
    tok = _tokens(tc, 2, 17, seed=2)
    caches = init_caches(tc, 2, 20, device="cpu")
    jcache = JM.init_caches(jc, 2, 20)
    lg, caches = prefill_step(tp, tc, {"tokens": torch.from_numpy(
        tok[:, :16])}, caches)
    jlg, jcache = JS.prefill_step(jp, jc, {"tokens": jnp.asarray(
        tok[:, :16])}, jcache)
    _close(lg.numpy(), np.asarray(jlg), TOL)
    _assert_caches_equal_jax(caches, jcache)
    lg, caches = decode_step(tp, tc, torch.from_numpy(tok[:, 16:]), caches,
                             16)
    jlg, jcache = JS.decode_step(jp, jc, jnp.asarray(tok[:, 16:]), jcache,
                                 jnp.int32(16))
    _close(lg.numpy(), np.asarray(jlg), TOL)
    _assert_caches_equal_jax(caches, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax(arch):
    jc, tc, jp, tp = _pair(arch)
    tok = _tokens(jc, 2, 8, seed=3)
    want = JS.greedy_generate(jp, jc, jnp.asarray(tok), max_new=6,
                              max_seq=24)
    got = greedy_generate(tp, tc, torch.from_numpy(tok), max_new=6,
                          max_seq=24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_keys_shapes_dtypes_match_jax(arch):
    jc, tc = jax_config(arch), get_config(arch)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        want = JM.init_caches(jc, 3, 20, jdtype)
        got = init_caches(tc, 3, 20, dtype, device="cpu")
        g, w = _leaves_with_paths(got), _leaves_with_paths(want)
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, gl), (_, wl) in zip(g, w):
            assert tuple(gl.shape) == wl.shape, path
            assert str(gl.dtype).split(".")[-1] == str(wl.dtype), path


@pytest.mark.parametrize("arch", ["mamba2-370m-smoke", "hymba-1.5b-smoke"])
def test_init_params_tree_and_distribution(arch):
    """The port's own init: the reference's tree, shapes and dtypes, its
    a_log, d_skip and dt_bias, and conv_w's N(0, 1 / d_conv) scale."""
    jc, tc = jax_config(arch), get_config(arch)
    want = JM.init_params(jc, jax.random.PRNGKey(0))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])

    tp = init_params(tc, 5, device="cpu")
    assert shapes(tp) == jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                                      want)
    got, ref = tp["layers"]["mixer"]["ssm"], want["layers"]["mixer"]["ssm"]
    for key in ("a_log", "d_skip", "dt_bias"):
        _close(got[key].numpy(), np.asarray(ref[key]), 1e-6)
    assert abs(float(got["conv_w"].std()) - 0.5) < 0.05
    again = init_params(tc, 5, device="cpu")
    assert torch.equal(again["layers"]["mixer"]["ssm"]["in_proj"],
                       got["in_proj"])


@pytest.mark.parametrize("arch", ["mamba2-370m-smoke", "hymba-1.5b-smoke"])
def test_scan_runs_in_prefill_and_forward_not_decode(arch):
    """A prefill and a forward without caches take the K7 wrapper once
    per layer (and, for hybrid heads, K6 too); decode takes neither. On
    the CPU the wrappers run their plain versions and count no launch,
    so the calls are counted here by wrapping them."""
    import repro_torch.kernels.ops as ops
    tc = get_config(arch)
    tp = init_params(tc, 0, device="cpu")
    scans, attns = [], []
    inner_scan, inner_fa = TSSM.ssd_scan, ops._fa.flash_attention

    def counting_scan(*a, **kw):
        scans.append(kw.get("init_state") is not None)
        return inner_scan(*a, **kw)

    def counting_fa(*a, **kw):
        attns.append(1)
        return inner_fa(*a, **kw)

    TSSM.ssd_scan, ops._fa.flash_attention = counting_scan, counting_fa
    try:
        toks = torch.from_numpy(_tokens(tc, 2, 16))
        forward(tp, tc, {"tokens": toks})
        assert scans == [False] * tc.num_layers
        caches = init_caches(tc, 2, 24, torch.float32, device="cpu")
        _, caches = prefill_step(tp, tc, {"tokens": toks}, caches)
        assert scans[tc.num_layers:] == [True] * tc.num_layers
        decode_step(tp, tc, toks[:, :1], caches, 16)
        assert len(scans) == 2 * tc.num_layers
        hybrid = tc.hybrid_parallel_heads
        assert len(attns) == (2 * tc.num_layers if hybrid else 0)
    finally:
        TSSM.ssd_scan, ops._fa.flash_attention = inner_scan, inner_fa


def test_ffn_runs_on_reduced_mamba2_and_is_skipped_at_width_zero():
    """The reference runs the FFN on every block: the reduced mamba2 has
    a 128-wide one that changes the logits; the full config's width is
    0, whose FFN adds an exact 0."""
    tc = get_config("mamba2-370m-smoke")
    assert tc.d_ff == 128 and get_config("mamba2-370m").d_ff == 0
    tp = init_params(tc, 0, device="cpu")
    tok = torch.from_numpy(_tokens(tc, 1, 16))
    base, _, _ = forward(tp, tc, {"tokens": tok})
    tp["layers"]["ffn"]["mlp"]["w_down"].zero_()
    assert not torch.equal(forward(tp, tc, {"tokens": tok})[0], base)


# ---------------------------------------------------------------------------
# the SSM caches' handoff over the engine
# ---------------------------------------------------------------------------

def _random_state_caches(side, cfg, b, max_seq, seed):
    """A filled cache tree of ``cfg``'s kind in the side's package
    (values from numpy; attention positions int32)."""
    rng = np.random.default_rng(seed)
    like = JM.init_caches(cfg, b, max_seq, jnp.float32)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if tree.dtype == jnp.int32:
            return side.array(np.full(tree.shape, max_seq - 3, np.int32))
        return side.array(rng.standard_normal(tree.shape).astype(np.float32))

    return fill(like)


@pytest.mark.parametrize("arch", ["tiny-ssm", "hymba-1.5b-smoke"])
def test_flatten_order_is_jax_tree_order(arch):
    cfg = jax_config(arch)

    def scenario(s):
        caches = _random_state_caches(s, cfg, 2, 10, seed=5)
        flat = _np(s.kv.flatten_cache_leaves(caches))
        back = s.kv.unflatten_cache_leaves(flat, caches)
        for (path, g), (_, w) in zip(_leaves_with_paths(back),
                                     _leaves_with_paths(caches)):
            np.testing.assert_array_equal(_np(g), _np(w), err_msg=str(path))
            assert _np(g).dtype == _np(w).dtype
        return flat

    flat = run_both(scenario)
    sizes = [int(np.prod(x.shape)) for _, x in _leaves_with_paths(
        JM.init_caches(cfg, 2, 10, jnp.float32))]
    assert flat.shape == (sum(sizes),)


@pytest.mark.parametrize("arch", ["tiny-ssm", "hymba-1.5b-smoke"])
@pytest.mark.parametrize("compressed", [False, True])
def test_state_handoff_pools_cqes_and_ledger_equal(arch, compressed):
    """Publish SSM (or hybrid) caches as pages, fetch them over
    one-sided READs: both packages' pools, CQEs, ``engine.stats`` (the
    ``kv_serve`` ledger included) and fetched leaves equal, and the
    uncompressed fetch returns the caches byte for byte."""
    cfg = jax_config(arch)

    def scenario(s):
        s.kv._wr_tokens = itertools.count(0x4B560000)
        eng = s.RDMAEngine(n_peers=2, pool_size=1 << 14)
        caches = _random_state_caches(s, cfg, 1, 12, seed=6)
        n_words = int(_np(s.kv.flatten_cache_leaves(caches)).size)
        n_pages = -(-n_words // PE)
        pool = s.kv.PagedKVPool(eng, 0, page_elems=PE, max_pages=n_pages,
                                compressed=compressed)
        client = s.kv.RemoteKVClient(eng, 1, pool,
                                     router=s.TrafficRouter())
        t = client.register_tenant("decode", weight=2)
        assert client.publish_caches(3, caches) == n_pages
        published = snapshot(eng)
        got = client.fetch_caches(3, caches, t)
        out = [_np(x) for _, x in _leaves_with_paths(got)]
        if not compressed:
            for g, (path, w) in zip(out, _leaves_with_paths(caches)):
                np.testing.assert_array_equal(g, _np(w), err_msg=str(path))
        led = eng.stats["kv_serve"]
        assert led["pages_fetched"] == n_pages and led["failed"] == 0
        return published, snapshot(eng), out

    run_both(scenario)


@pytest.mark.parametrize("arch", ["tiny-ssm", "hymba-1.5b-smoke"])
def test_greedy_decode_bit_identical_through_remote_pool(arch):
    """prefill -> publish -> one-sided-READ fetch -> decode gives the
    local tokens, which are JAX's on the same weights."""
    jc, cfg, jp, params = _pair(arch)
    prompt = _tokens(cfg, 1, 8, seed=4)
    tp = torch.from_numpy(prompt)
    base = greedy_generate(params, cfg, tp, max_new=4, max_seq=32)
    want = JS.greedy_generate(jp, jc, jnp.asarray(prompt), max_new=4,
                              max_seq=32)
    np.testing.assert_array_equal(base.numpy(), np.asarray(want))

    kv = TORCH.kv
    n_words = kv.flatten_cache_leaves(
        init_caches(cfg, 1, 32, torch.float32, device="cpu")).numel()
    n_pages = -(-int(n_words) // PE)
    eng = TORCH.RDMAEngine(n_peers=2, pool_size=4 * n_pages * PE)
    pool = kv.PagedKVPool(eng, 0, page_elems=PE, max_pages=n_pages)
    client = kv.RemoteKVClient(eng, 1, pool)
    t = client.register_tenant("decode", weight=2)
    out = greedy_generate(params, cfg, tp, max_new=4, max_seq=32,
                          kv_client=client, kv_seq_id=0, kv_tenant=t)
    np.testing.assert_array_equal(out.numpy(), base.numpy())
    assert pool.allocated == 0
    led = eng.stats["kv_serve"]
    assert led["pages_fetched"] == n_pages and led["failed"] == 0


@pytest.mark.parametrize("arch", ["mamba2-370m-smoke", "hymba-1.5b-smoke"])
def test_serve_launcher_on_cpu(arch):
    res = run(arch, n_requests=3, prompt_len=16, gen_len=4, max_seq=28,
              device="cpu")
    assert res["device"] == "cpu" and res["arch"] == arch
    assert res["output_shape"] == [3, 4] and res["no_nans"]
    assert res["prefill_s"] > 0 and res["decode_tokens_per_s"] > 0


def test_launcher_default_device_is_the_gpu(monkeypatch):
    """Without ``--device`` the launcher asks for CUDA and raises where
    there is none, rather than serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("mamba2-370m-smoke", n_requests=1, prompt_len=16, gen_len=2)

