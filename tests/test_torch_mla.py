"""The port's MLA (DeepSeek-V2 multi-head latent attention) against the
JAX package, on the CPU.

``mla_block`` with and without a cache, K6's plain version at MLA's head
dims (q and k 192 wide, v 128) against the reference's
``attention_core``, and the compressed cache's handoff over the engine.
Weights come from the JAX package through ``params_from_jax``, inputs
from numpy seeds. Tolerance: ``TOL = 5e-5`` (as in
``tests/test_torch_models.py``; sums in another order); the handoff is
byte-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
import repro.models.layers as JL
import repro.serve as JS
import repro.serve.kv_cache as JKV
from repro.configs.registry import get_config as jax_config
from repro_torch.configs.registry import get_config
from repro_torch.core.rdma import RDMAEngine
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import init_caches, params_from_jax
from repro_torch.models.layers import init_mla, mla_block
from repro_torch.serve import (PagedKVPool, RemoteKVClient, greedy_generate,
                               prefill_step)
from repro_torch.serve.kv_cache import flatten_cache_leaves

ARCH = "deepseek-v2-lite-16b-smoke"
TOL = 5e-5
PE = 1024


def _mla_pair(seed=0):
    jc, tc = jax_config(ARCH), get_config(ARCH)
    jp = JL.init_mla(jax.random.PRNGKey(seed), jc, jnp.float32)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _pos(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


def test_init_mla_tree_matches_jax():
    jc, tc, jp, _ = _mla_pair()
    want = {k: (v.shape, str(v.dtype)) for k, v in jp.items()}
    got = init_mla(torch.Generator().manual_seed(0), tc, torch.float32,
                   "cpu", None)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == want
    stacked = init_mla(torch.Generator().manual_seed(0), tc, torch.float32,
                       "cpu", 3)
    assert all(v.shape == (3, *want[k][0]) for k, v in stacked.items())


@pytest.mark.parametrize("b,s", [(2, 13), (1, 1), (3, 32)])
def test_mla_block_without_cache_matches_jax(b, s):
    jc, tc, jp, tp = _mla_pair()
    x, pos = _x(jc, b, s, seed=s), _pos(b, s)
    want, jcache = JL.mla_block(jp, jc, jnp.asarray(x), jnp.asarray(pos))
    got, cache = mla_block(tp, tc, torch.from_numpy(x), torch.from_numpy(pos))
    assert jcache is None and cache is None
    assert got.shape == (b, s, tc.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_mla_block_with_cache_matches_jax(cache_dtype):
    """Prefill 10 tokens at position 0 (K6's path: the new tokens alone),
    then one token at 10 and three at 11 (the whole cache up-projected,
    ``kv_len`` masked): outputs and the written ``c_kv``, ``k_rope`` and
    ``pos`` equal JAX's, also when the cache holds bf16."""
    jc, tc, jp, tp = _mla_pair(seed=1)
    b, max_seq = 2, 16
    m = tc.mla
    jdt = jnp.float32 if cache_dtype == torch.float32 else jnp.bfloat16
    jcache = {"c_kv": jnp.zeros((b, max_seq, m.kv_lora_rank), jdt),
              "k_rope": jnp.zeros((b, max_seq, m.qk_rope_head_dim), jdt),
              "pos": jnp.int32(0)}
    cache = {"c_kv": torch.zeros((b, max_seq, m.kv_lora_rank),
                                 dtype=cache_dtype),
             "k_rope": torch.zeros((b, max_seq, m.qk_rope_head_dim),
                                   dtype=cache_dtype),
             "pos": torch.zeros((), dtype=torch.int32)}
    for start, s in ((0, 10), (10, 1), (11, 3)):
        x, pos = _x(jc, b, s, seed=start + 7), _pos(b, s, start)
        want, jcache = JL.mla_block(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                                    cache=jcache)
        got, cache = mla_block(tp, tc, torch.from_numpy(x),
                               torch.from_numpy(pos), cache=cache, pos=start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        assert int(cache["pos"]) == int(jcache["pos"]) == start + s
        for key in ("c_kv", "k_rope"):
            assert cache[key].dtype == cache_dtype
            np.testing.assert_allclose(
                cache[key].float().numpy(),
                np.asarray(jcache[key].astype(jnp.float32)), rtol=TOL,
                atol=TOL)


@pytest.mark.parametrize("sq,skv,causal,hq,hkv", [
    (37, 37, True, 4, 4), (20, 33, False, 4, 2), (1, 9, False, 2, 2),
    (64, 64, True, 2, 1)])
def test_plain_k6_at_mla_heads_matches_attention_core(sq, skv, causal, hq,
                                                      hkv):
    """K6's plain version (what the wrapper runs on CPU tensors) at
    q, k 192 and v 128 against the reference's ``attention_core``: the
    output is 128 wide and scaled by 192^-0.5."""
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((2, sq, hq, 192)).astype(np.float32)
    k = rng.standard_normal((2, skv, hkv, 192)).astype(np.float32)
    v = rng.standard_normal((2, skv, hkv, 128)).astype(np.float32)
    want = JL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    assert got.shape == (2, sq, hq, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _deepseek():
    jc, tc = jax_config(ARCH), get_config(ARCH)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def test_mla_cache_handoff_round_trips_byte_exact():
    """The prefill-filled MLA caches (the stack's ``c_kv``, ``k_rope``,
    ``pos`` and the dense block's) published as pages and fetched over
    one-sided READs on the CPU engine come back byte for byte, flattened
    in the reference's leaf order; greedy tokens through the remote pool
    equal local ones and JAX's."""
    jc, tc, jp, tp = _deepseek()
    prompt = np.random.default_rng(0).integers(
        0, tc.vocab_size, (2, 8)).astype(np.int32)
    caches = init_caches(tc, 2, 24, torch.float32, device="cpu")
    _, caches = prefill_step(tp, tc, {"tokens": torch.from_numpy(prompt)},
                             caches)
    jcaches = JM.init_caches(jc, 2, 24, jnp.float32)
    _, jcaches = JS.prefill_step(jp, jc, {"tokens": jnp.asarray(prompt)},
                                 jcaches)
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
    assert set(got) == {"scan", "dense"}
    for part, sub in (("scan", got["scan"]), ("dense", got["dense"]["0"])):
        want = caches[part] if part == "scan" else caches["dense"]["0"]
        assert set(sub) == {"c_kv", "k_rope", "pos"}
        for key in sub:
            assert sub[key].dtype == want[key].dtype
            assert torch.equal(sub[key], want[key]), (part, key)
    pool.evict(3)

    tok = torch.from_numpy(prompt)
    local = greedy_generate(tp, tc, tok, max_new=4, max_seq=24)
    remote = greedy_generate(tp, tc, tok, max_new=4, max_seq=24,
                             kv_client=client, kv_seq_id=0, kv_tenant=t)
    want = JS.greedy_generate(jp, jc, jnp.asarray(prompt), max_new=4,
                              max_seq=24)
    assert torch.equal(local, remote)
    np.testing.assert_array_equal(local.numpy(), np.asarray(want))
    assert pool.allocated == 0
    led = eng.stats["kv_serve"]
    assert led["failed"] == 0 and led["pages_fetched"] == 2 * n_pages


def test_full_size_mla_cache_is_the_compressed_latent():
    """deepseek-v2-lite-16b's caches for 8 sequences of 552 tokens, laid
    out on the meta device: 27 layers x 576 words (512 latent + 64 rope)
    per token, 1048 pages of 65,536 words, 8.9x fewer than per-head K/V
    (16 heads x (192 + 128)) for the same tokens."""
    cfg = get_config("deepseek-v2-lite-16b")
    caches = init_caches(cfg, 8, 552, torch.float32, device="meta")
    leaves = [caches["scan"][k] for k in ("c_kv", "k_rope", "pos")] + [
        caches["dense"]["0"][k] for k in ("c_kv", "k_rope", "pos")]
    words = sum(t.numel() for t in leaves)
    assert caches["scan"]["c_kv"].shape == (26, 8, 552, 512)
    assert words == 27 * 8 * 552 * 576 + 27
    assert -(-words // 65536) == 1048
    per_head = 27 * 8 * 552 * 16 * (192 + 128)
    assert 8.8 < per_head / words < 8.9
