"""The port's encoder-decoder stack (seamless-m4t) against the JAX
package, on the CPU.

The encoder over the frontend stub's frame embeddings, the decoder's
cross-attention, the ``{"self": ...}`` decoder caches, prefill + decode
with ``enc_embeds`` passed to every step (``decode_step(extra=)``), the
loss and its gradients, and the caches' handoff over the engine. Weights
come from the JAX package through ``params_from_jax``; tokens and frame
embeddings from numpy seeds (``serve.inputs.model_inputs``, laid out as
the reference's ``launch/specs.py:serve_input_specs``). Tolerance:
``TOL = 5e-5``, as in ``tests/test_torch_models.py`` (sums in another
order); greedy tokens equal, the handoff byte-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
import repro.models.transformer as JT
import repro.serve as JS
import repro.serve.kv_cache as JKV
from repro.configs.base import ShapeConfig
from repro.configs.registry import get_config as jax_config
from repro.launch.specs import serve_input_specs
from repro_torch.configs.registry import get_config
from repro_torch.core.rdma import RDMAEngine
from repro_torch.launch.serve import run
from repro_torch.models import (forward, init_caches, init_params, loss_fn,
                                params_from_jax)
from repro_torch.models.transformer import embed_inputs, encode
from repro_torch.serve import (PagedKVPool, RemoteKVClient, decode_step,
                               model_inputs, prefill_step, step_inputs)
from repro_torch.serve.kv_cache import flatten_cache_leaves

from _torch_serving import greedy_jax, greedy_port, pair
from _torch_serving import shapes as _shapes
from _torch_serving import to_jnp as _jnp
from _torch_serving import tokens as _tokens

ARCH = "seamless-m4t-large-v2-smoke"
TOL = 5e-5
PE = 1024


def _pair():
    jc, tc = jax_config(ARCH), get_config(ARCH)
    return (jc, tc, *pair(jc))


def test_init_params_tree_matches_jax():
    """The port's own init: ``enc_layers`` (no cross) and ``dec_layers``
    (with ``cross_norm_scale`` and a ``cross`` attention), shapes and
    dtypes as the reference's."""
    jc, tc = jax_config(ARCH), get_config(ARCH)
    want = _shapes(jax.eval_shape(
        lambda: JM.init_params(jc, jax.random.PRNGKey(0))))
    tp = init_params(tc, 3, device="cpu")
    assert _shapes(tp) == want
    assert set(tp) == {"embed", "final_norm_scale", "lm_head", "enc_layers",
                       "dec_layers"}
    assert "cross" in tp["dec_layers"] and "cross" not in tp["enc_layers"]
    assert tp["enc_layers"]["pre_norm_scale"].shape[0] == tc.encoder_layers


def test_params_from_jax_carries_both_stacks():
    jc, tc, jp, tp = _pair()
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jp))
    got = jax.tree_util.tree_leaves(tp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, torch.from_numpy(np.array(w)))
    assert _shapes(tp["dec_layers"]["cross"]) == _shapes(
        jp["dec_layers"]["cross"])


def _jax_encoder(jp, jc, x):
    pos = jnp.broadcast_to(jnp.arange(x.shape[1], dtype=jnp.int32),
                           x.shape[:2])
    return JT._scan_stack(jp["enc_layers"], jc, x, pos,
                          JT.layer_windows(jc, jc.encoder_layers), None, None,
                          causal=False)[0]


def test_encoder_matches_jax_and_is_not_causal():
    """``encode`` against the reference's encoder stack (``_scan_stack``
    over ``enc_layers``, not causal, RoPE over the frames): a change to
    the last frame reaches the first frame's output."""
    jc, tc, jp, tp = _pair()
    x = np.random.default_rng(3).standard_normal(
        (2, 9, jc.d_model)).astype(np.float32)
    want = _jax_encoder(jp, jc, jnp.asarray(x))
    got = encode(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved = encode(tp, tc, torch.from_numpy(x2))
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-3


def test_encoder_frames_take_the_params_dtype():
    """The port's encoder runs in the parameters' dtype whatever the
    frames' dtype; the reference's does not. With bf16 weights and f32
    frames JAX promotes and runs the encoder in f32, the port rounds the
    frames to bf16 first: the two differ by bf16 rounding, held within
    two bf16 steps of the largest output (one step where both run in
    bf16, sums in another order). With f32 weights and bf16 frames the
    reference's scanned stack refuses (its carry changes dtype), the
    port computes in f32."""
    jc, tc = jax_config(ARCH), get_config(ARCH)
    x = np.random.default_rng(3).standard_normal(
        (2, 9, jc.d_model)).astype(np.float32)
    jp = JM.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    got = encode(tp, tc, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, encode(tp, tc, torch.from_numpy(x).bfloat16()))
    promoted = _jax_encoder(jp, jc, jnp.asarray(x))
    assert promoted.dtype == jnp.float32
    same = _jax_encoder(jp, jc, jnp.asarray(x, jnp.bfloat16))
    assert same.dtype == jnp.bfloat16
    scale = float(jnp.abs(promoted).max())
    step = 2.0 ** (np.floor(np.log2(scale)) - 7)      # bf16's at the scale
    for want, steps in ((promoted, 2), (same, 1)):
        err = np.abs(got.float().numpy()
                     - np.asarray(want.astype(jnp.float32))).max()
        assert err <= steps * step, (err, steps * step)

    jp32, tp32 = pair(jc)
    with pytest.raises(TypeError, match="carry"):
        _jax_encoder(jp32, jc, jnp.asarray(x, jnp.bfloat16))
    frames = torch.from_numpy(x).bfloat16()
    got32 = encode(tp32, tc, frames)
    assert got32.dtype == torch.float32
    assert torch.equal(got32, encode(tp32, tc, frames.float()))


@pytest.mark.parametrize("b,s,s_enc", [(2, 16, 4), (3, 7, 11), (1, 1, 1)])
def test_forward_logits_match_jax(b, s, s_enc):
    jc, tc, jp, tp = _pair()
    tok = _tokens(jc, b, s)
    enc = np.random.default_rng(s).standard_normal(
        (b, s_enc, jc.d_model)).astype(np.float32)
    want, _, _ = JM.forward(jp, jc, {"tokens": jnp.asarray(tok),
                                     "enc_embeds": jnp.asarray(enc)})
    got, caches, aux = forward(tp, tc, {"tokens": torch.from_numpy(tok),
                                        "enc_embeds": torch.from_numpy(enc)})
    assert caches is None and float(aux) == 0.0
    assert got.shape == (b, s, tc.padded_vocab())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_frontend_stub_embeds_pass_through():
    """Without ``enc_embeds``, a frontend-stub model takes ``embeds`` as
    its decoder input, as the reference's ``embed_inputs`` does."""
    jc, tc, jp, tp = _pair()
    tok = _tokens(jc, 2, 5)
    emb = np.random.default_rng(1).standard_normal(
        (2, 5, jc.d_model)).astype(np.float32)
    want = JT.embed_inputs(jp, jc, {"tokens": jnp.asarray(tok),
                                    "embeds": jnp.asarray(emb)})
    got = embed_inputs(tp, tc, {"tokens": torch.from_numpy(tok),
                                "embeds": torch.from_numpy(emb)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with_enc = embed_inputs(tp, tc, {"tokens": torch.from_numpy(tok),
                                     "embeds": torch.from_numpy(emb),
                                     "enc_embeds": torch.zeros(2, 1, 64)})
    assert torch.equal(with_enc, tp["embed"][torch.from_numpy(tok)])


def test_init_caches_keys_and_shapes_match_jax():
    jc, tc = jax_config(ARCH), get_config(ARCH)
    want = JM.init_caches(jc, 3, 20, jnp.float32)
    got = init_caches(tc, 3, 20, torch.float32, device="cpu")
    assert _shapes(got) == _shapes(want)
    assert set(got) == {"scan"} and set(got["scan"]) == {"self"}
    assert set(got["scan"]["self"]) == {"k", "v", "pos"}
    assert got["scan"]["self"]["k"].shape == (tc.num_layers, 3, 20,
                                              tc.num_kv_heads, 16)


def test_inputs_follow_the_reference_serving_layout():
    """``model_inputs`` gives what ``serve_input_specs`` lays out: frame
    embeddings (B, S / encoder_seq_ratio, D) for prefill and decode."""
    jc, tc = jax_config(ARCH), get_config(ARCH)
    for kind, s in (("prefill", 32), ("decode", 1)):
        specs = serve_input_specs(jc, ShapeConfig("t", 32, 4, kind), kind)
        got = step_inputs(model_inputs(tc, 4, 32, 33, device="cpu"), 0, s)
        assert set(got) == set(specs) - {"tokens", "pos", "caches"}
        assert tuple(got["enc_embeds"].shape) == specs["enc_embeds"].shape


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_prefill_decode_matches_full_forward_and_jax(cache_dtype):
    """``tests/test_models.py``'s invariant with ``enc_embeds`` on every
    step: prefill 12 tokens, decode 4 teacher-forced; each step's logits
    equal the full forward's (f32 caches) and JAX's steps on caches of
    the same dtype, within TOL; the caches equal JAX's (bf16 ones within
    one bf16 step)."""
    jc, tc, jp, tp = _pair()
    tok = _tokens(tc, 2, 16, seed=1)
    toks = torch.from_numpy(tok)
    inp = model_inputs(tc, 2, 16, seed=2, device="cpu")
    full, _, _ = forward(tp, tc, {"tokens": toks, **inp})
    jdt = jnp.float32 if cache_dtype == torch.float32 else jnp.bfloat16
    caches = init_caches(tc, 2, 16, cache_dtype, device="cpu")
    jcache = JM.init_caches(jc, 2, 16, jdt)
    lg, caches = prefill_step(tp, tc, {"tokens": toks[:, :12], **inp},
                              caches)
    jlg, jcache = JS.prefill_step(
        jp, jc, _jnp({"tokens": tok[:, :12], **inp}), jcache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=TOL,
                               atol=TOL)
    errs = [float((lg[:, -1] - full[:, 11]).abs().max())]
    for i in range(12, 16):
        lg, caches = decode_step(tp, tc, toks[:, i:i + 1], caches, i,
                                 extra=inp)
        jlg, jcache = JS.decode_step(jp, jc, jnp.asarray(tok[:, i:i + 1]),
                                     jcache, jnp.int32(i), extra=_jnp(inp))
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=TOL,
                                   atol=TOL)
    if cache_dtype == torch.float32:
        assert max(errs) < TOL, errs
    got = jax.tree_util.tree_leaves(caches)
    want = jax.tree_util.tree_leaves(jcache)
    assert len(got) == len(want) == 3
    # a bf16 entry may round to the neighbour of JAX's: one bf16 step
    rtol = TOL if cache_dtype == torch.float32 else 2.0 ** -7
    for g, w in zip(got, want):
        assert g.dtype == cache_dtype or g.dtype == torch.int32
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w).astype(np.float32),
                                   rtol=rtol, atol=TOL)


def test_greedy_tokens_equal_jax():
    """Greedy decoding with the frames on every step (the reference's
    ``greedy_generate`` feeds tokens alone, so both sides run their own
    loop over ``prefill_step`` and ``decode_step(extra=)``)."""
    jc, tc, jp, tp = _pair()
    prompt = _tokens(tc, 2, 8, seed=2)
    inp = model_inputs(tc, 2, 8, 14, seed=3, device="cpu")
    want = greedy_jax(jc, jp, prompt, inp, 6, 24)
    got = greedy_port(tc, tp, prompt, inp, 6, 24)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError, match="enc_embeds"):
        JS.greedy_generate(jp, jc, jnp.asarray(prompt), max_new=2,
                           max_seq=12)


def test_loss_and_grads_match_jax():
    jc, tc, jp, tp = _pair()
    tok = _tokens(jc, 2, 13, seed=4)
    enc = model_inputs(tc, 2, 12, seed=5, device="cpu")["enc_embeds"]
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "enc_embeds": enc.numpy()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, _jnp(batch)))(jp)
    leaves = jax.tree_util.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = loss_fn(tp, tc, {k: torch.from_numpy(v) for k, v in
                            batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL,
                               atol=TOL)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
    # the encoder's and the cross-attention's weights are trained too
    for leaf in (tp["enc_layers"]["mixer"]["attn"]["wq"],
                 tp["dec_layers"]["cross"]["wk"]):
        i = next(j for j, x in enumerate(leaves) if x is leaf)
        assert float(grads[i].abs().max()) > 0


def test_remat_loss_and_grads_equal_plain():
    """``remat`` checkpoints the encoder's blocks and the decoder's (the
    cross-attention inside): loss and gradients equal the unchecked
    forward's."""
    _, tc, _, tp = _pair()
    tok = _tokens(tc, 2, 9, seed=6)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:]),
             **model_inputs(tc, 2, 8, seed=7, device="cpu")}
    leaves = jax.tree_util.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    out = []
    for remat in (False, True):
        loss = loss_fn(tp, tc, batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for g, e in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=1e-7)


def test_k6_runs_encoder_self_and_cross_attention():
    """The K6 wrapper (counted here by wrapping it: on the CPU it runs
    its plain version and counts no launch) runs 3 x layers per forward
    and prefill (encoder, decoder self, cross) and 2 x layers per decode
    step (the encoder again, and the cross-attention: neither has a
    cache); the decoder's self-attention over its cache is plain."""
    import repro_torch.kernels.ops as ops
    tc = get_config(ARCH)
    tp = init_params(tc, 0, device="cpu")
    calls = []
    inner = ops._fa.flash_attention

    def counting(*a, **kw):
        calls.append((a[0].shape[1], a[1].shape[1], kw.get("causal")))
        return inner(*a, **kw)

    n_enc, n_dec = tc.encoder_layers, tc.num_layers
    ops._fa.flash_attention = counting
    try:
        toks = torch.from_numpy(_tokens(tc, 2, 9))
        inp = model_inputs(tc, 2, 8, seed=1, device="cpu")
        forward(tp, tc, {"tokens": toks, **inp})
        assert len(calls) == n_enc + 2 * n_dec
        assert calls[:n_enc] == [(2, 2, False)] * n_enc
        assert sorted(calls[n_enc:]) == sorted(
            [(9, 9, True), (9, 2, False)] * n_dec)
        caches = init_caches(tc, 2, 16, torch.float32, device="cpu")
        _, caches = prefill_step(tp, tc, {"tokens": toks, **inp}, caches)
        assert len(calls) == 2 * (n_enc + 2 * n_dec)
        calls[:] = []
        decode_step(tp, tc, toks[:, :1], caches, 9, extra=inp)
        assert calls == [(2, 2, False)] * n_enc + [(1, 2, False)] * n_dec
    finally:
        ops._fa.flash_attention = inner


def test_self_cache_handoff_round_trips_byte_exact():
    """The prefill-filled ``{"self": {"k", "pos", "v"}}`` caches published
    as pages and fetched over one-sided READs on the CPU engine come back
    byte for byte, flattened in the reference's leaf order; greedy tokens
    through the remote pool equal local ones and JAX's."""
    jc, tc, jp, tp = _pair()
    prompt = _tokens(tc, 2, 8)
    inp = model_inputs(tc, 2, 8, 12, seed=4, device="cpu")
    pre = {"tokens": torch.from_numpy(prompt), **step_inputs(inp, 0, 8)}
    caches = init_caches(tc, 2, 24, torch.float32, device="cpu")
    _, caches = prefill_step(tp, tc, pre, caches)
    jcaches = JM.init_caches(jc, 2, 24, jnp.float32)
    _, jcaches = JS.prefill_step(jp, jc, _jnp(pre), jcaches)
    flat = flatten_cache_leaves(caches)
    np.testing.assert_allclose(flat.numpy(),
                               np.asarray(JKV.flatten_cache_leaves(jcaches)),
                               rtol=TOL, atol=TOL)
    n_pages = -(-flat.numel() // PE)
    eng = RDMAEngine(n_peers=2, pool_size=4 * n_pages * PE, device="cpu")
    pool = PagedKVPool(eng, 0, page_elems=PE, max_pages=n_pages)
    client = RemoteKVClient(eng, 1, pool)
    t = client.register_tenant("decode", weight=2)
    assert client.publish_caches(3, caches) == n_pages
    got = client.fetch_caches(3, caches, t)
    assert set(got) == {"scan"} and set(got["scan"]) == {"self"}
    for key in ("k", "v", "pos"):
        g, w = got["scan"]["self"][key], caches["scan"]["self"][key]
        assert g.dtype == w.dtype and torch.equal(g, w), key
    pool.evict(3)

    remote = greedy_port(tc, tp, prompt, inp, 4, 24, kv_client=client,
                         kv_seq_id=0, kv_tenant=t)
    local = greedy_port(tc, tp, prompt, inp, 4, 24)
    want = greedy_jax(jc, jp, prompt, inp, 4, 24)
    np.testing.assert_array_equal(remote, local)
    np.testing.assert_array_equal(local, want)
    assert pool.allocated == 0
    led = eng.stats["kv_serve"]
    assert led["failed"] == 0 and led["pages_fetched"] == 2 * n_pages


def test_full_size_self_caches_need_the_larger_pool():
    """seamless-m4t-large-v2's decoder caches for 8 sequences of 552
    tokens, laid out on the meta device: 24 x 2 x 8 x 552 x 16 x 64 words
    and 24 positions, 3313 pages of 65,536 words, more than 2^27 words
    and within 2^28."""
    cfg = get_config("seamless-m4t-large-v2")
    caches = init_caches(cfg, 8, 552, torch.float32, device="meta")
    words = sum(t.numel() for t in jax.tree_util.tree_leaves(caches))
    assert words == 24 * 2 * 8 * 552 * 16 * 64 + 24 == 217_055_256
    pages = -(-words // 65536)
    assert pages == 3313 and 1 << 27 < pages * 65536 <= 1 << 28


def test_serve_launcher_feeds_tokens_only():
    """The launcher serves tokens alone, as the reference's does: an
    enc-dec model has no frames there, and raises for them."""
    with pytest.raises(KeyError, match="enc_embeds"):
        run(ARCH, n_requests=2, prompt_len=8, gen_len=2, max_seq=12,
            device="cpu")
