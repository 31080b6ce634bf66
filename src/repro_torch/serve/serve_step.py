"""Serving steps: prefill + decode over the model's caches (attention
KV, an enc-dec decoder's under ``"self"``, MLA's compressed latent, SSM
conv and state, or attention and SSM for hybrid heads), and a greedy
loop.

Positions are host ints: prefill starts at 0 and decode knows its step,
so no step reads a cache's ``pos`` back from the device.

With ``tp`` (a ``models.sharding.TensorParallel`` over the rank's
``model`` group) a step is one rank's share on its cut of the
parameters and of the caches (``init_caches(tp_size=)``: K and V cut on
the head dim, MLA's latent and rope key on their feature dims, the SSM's
conv on its channels and its state on its head dim, as
``launch.specs.cache_partition_specs`` cuts them; a decode step scores
the cut where it lies and updates the state's cut where it lies), and
the logits are its cut of the vocab. Every family takes the cut.
Serving runs without sequence parallelism, as the reference's serving
forward does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward, init_caches


def prefill_step(params, cfg: ModelConfig, batch: dict, caches, tp=None):
    """Process the prompt from position 0, filling caches. ``batch`` goes
    to the forward whole (tokens, and ``enc_embeds``, ``patch_embeds``,
    ``mrope_positions`` where the model takes them). Returns
    (last_logits (B, 1, V), caches)."""
    logits, caches, _ = forward(params, cfg, batch, caches=caches, pos=0,
                                tp=tp)
    return logits[:, -1:], caches


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, caches,
                pos: int, extra: Optional[dict] = None, tp=None):
    """One decode step. tokens: (B, 1); pos: host int, the position the
    tokens take (their cache slot). ``extra`` joins the batch: an enc-dec
    model's ``enc_embeds``, a VLM's ``mrope_positions`` (3, B, 1).
    Returns (logits (B, 1, V), caches)."""
    b = tokens.shape[0]
    batch = {"tokens": tokens,
             "positions": torch.full((b, 1), pos, dtype=torch.int32,
                                     device=tokens.device)}
    if extra:
        batch.update(extra)
    logits, caches, _ = forward(params, cfg, batch, caches=caches, pos=pos,
                                tp=tp)
    return logits, caches


def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    max_new: int, max_seq: int, dtype=torch.float32,
                    kv_client=None, kv_seq_id: int = 0, kv_tenant=None):
    """Greedy loop (prefill + decode) on the prompt's device.

    With ``kv_client`` (a ``serve.kv_cache.RemoteKVClient``), the
    prefill-filled caches take the disaggregated-serving handoff before
    decode: published as pages into the remote KV pool, then fetched
    back over one-sided READ WQEs on ``kv_tenant``'s QP. Decode runs on
    the fetched caches — bit-identical tokens for uncompressed f32
    pools. Tokens only, as in the reference: an enc-dec model, which
    needs ``enc_embeds``, is served by ``prefill_step`` and
    ``decode_step(extra=)``. Returns (B, max_new) token ids."""
    b, s = prompt.shape
    caches = init_caches(cfg, b, max_seq, dtype, device=prompt.device)
    logits, caches = prefill_step(params, cfg, {"tokens": prompt}, caches)
    if kv_client is not None:
        caches = kv_client.roundtrip_caches(kv_seq_id, caches, kv_tenant)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    outs = [tok]
    pos = s
    for _ in range(max_new - 1):
        logits, caches = decode_step(params, cfg, tok, caches, pos)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        outs.append(tok)
        pos += 1
    return torch.cat(outs, dim=1)
