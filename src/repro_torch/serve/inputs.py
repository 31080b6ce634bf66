"""Serving inputs beside the tokens, for the families that take them.

The layout is the reference's serving batch
(``repro/launch/specs.py:serve_input_specs``): a prefill of ``S`` tokens
takes ``enc_embeds`` (B, S / encoder_seq_ratio, D) for an enc-dec model
(the speech frontend is a stub: precomputed frame embeddings), and
``mrope_positions`` (3, B, S) with ``patch_embeds`` (B, S /
vision_patches_ratio, D) for a VLM (the vision tower is a stub:
precomputed patch embeddings over the first positions); a decode step
takes ``enc_embeds`` again and the step's ``mrope_positions`` (3, B, 1).
``greedy_with_inputs`` is ``greedy_generate`` for such a model: its loop
gives each step its share.

The M-RoPE ids follow Qwen2-VL (arXiv:2409.12191, §2.1) for one image in
front of the text: the patches are one frame (t = 0) on a ``gh x gw``
grid with h the row and w the column, and each text token after them
takes t = h = w, counting on from the largest image id + 1. The values
are random from a numpy seed: N(0, 1) frames, and N(0, 1) patches scaled
as the embedding rows are initialised (``init_dense``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import init_caches
from repro_torch.serve.serve_step import decode_step, prefill_step


def image_grid(n_patches: int) -> Tuple[int, int]:
    """(rows, columns) of an image of ``n_patches`` patches: columns the
    largest divisor of 16 that divides ``n_patches`` (8 x 16 for 128)."""
    gw = math.gcd(n_patches, 16)
    return n_patches // gw, gw


def mrope_ids(batch: int, n_tokens: int, n_patches: int,
              device=None) -> torch.Tensor:
    """(3, batch, n_tokens) int32 (t, h, w) ids: ``n_patches`` image
    patches on ``image_grid(n_patches)`` first, then text."""
    gh, gw = image_grid(n_patches)
    ids = np.empty((3, n_tokens), np.int32)
    p = min(n_patches, n_tokens)
    idx = np.arange(p)
    ids[0, :p], ids[1, :p], ids[2, :p] = 0, idx // gw, idx % gw
    ids[:, p:] = max(gh, gw) + np.arange(n_tokens - p)
    return torch.from_numpy(np.broadcast_to(ids[:, None], (3, batch, n_tokens))
                            .copy()).to(resolve_device(device))


def model_inputs(cfg: ModelConfig, batch: int, prompt_len: int,
                 n_tokens: Optional[int] = None, *, seed: int = 0,
                 device=None) -> dict:
    """What ``cfg`` takes beside tokens for a prompt of ``prompt_len``
    and positions up to ``n_tokens`` (default: the prompt): ``{}`` for a
    model that takes tokens alone. Frames and patches are f32; the model
    casts them to its parameters' dtype."""
    dev = resolve_device(device)
    n_tokens = prompt_len if n_tokens is None else n_tokens
    rng = np.random.default_rng(seed)
    d = cfg.d_model

    def normal(*shape, scale=1.0):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(x).to(dev)

    out = {}
    if cfg.enc_dec:
        out["enc_embeds"] = normal(batch, prompt_len // cfg.encoder_seq_ratio,
                                   d)
    if cfg.mrope:
        n_patches = prompt_len // cfg.vision_patches_ratio
        out["patch_embeds"] = normal(
            batch, n_patches, d,
            scale=(2.0 / (cfg.padded_vocab() + d)) ** 0.5)
        out["mrope_positions"] = mrope_ids(batch, n_tokens, n_patches, dev)
    return out


def step_inputs(inputs: dict, start: int, stop: int) -> dict:
    """``model_inputs``' share of positions ``start:stop``: the step's
    M-RoPE ids, the encoder's frames on every step, the patches only on
    a step from position 0 (a prefill or a forward)."""
    out = {}
    if "enc_embeds" in inputs:
        out["enc_embeds"] = inputs["enc_embeds"]
    if "mrope_positions" in inputs:
        out["mrope_positions"] = inputs["mrope_positions"][:, :, start:stop]
        if start == 0:
            out["patch_embeds"] = inputs["patch_embeds"]
    return out


def greedy_with_inputs(params, cfg: ModelConfig, prompt: torch.Tensor,
                       inputs: dict, max_new: int, max_seq: int,
                       dtype=torch.float32, kv_client=None,
                       kv_seq_id: int = 0, kv_tenant=None) -> torch.Tensor:
    """``serve_step.greedy_generate`` for a model that takes ``inputs``
    (``model_inputs``) beside the tokens: the prefill and each decode
    step given their share (``step_inputs``), the prefill-filled caches
    handed over through ``kv_client`` before decode as there. Returns
    (B, max_new) token ids."""
    b, s = prompt.shape
    caches = init_caches(cfg, b, max_seq, dtype, device=prompt.device)
    logits, caches = prefill_step(
        params, cfg, {"tokens": prompt, **step_inputs(inputs, 0, s)},
        caches)
    if kv_client is not None:
        caches = kv_client.roundtrip_caches(kv_seq_id, caches, kv_tenant)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    outs = [tok]
    for pos in range(s, s + max_new - 1):
        logits, caches = decode_step(params, cfg, tok, caches, pos,
                                     extra=step_inputs(inputs, pos, pos + 1))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        outs.append(tok)
    return torch.cat(outs, dim=1)
