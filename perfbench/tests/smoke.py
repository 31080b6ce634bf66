"""Small stand-ins of the benchmark's cells for the CPU tests: the port's
``-smoke`` config of a cell's arch (two layers, narrow widths, the same
mechanisms), the configuration file's keys restated for it, a model
axis whose cuts take the same routes as the cell's (deepseek's one head
a rank over an axis of 4, hymba's heads and SSM heads not dividing an
axis of 16), short traffic, and the run's result from
``harness.execute`` on the CPU."""
from __future__ import annotations

import time

import torch

from perfbench import harness

CELLS = {"deepseek": "deepseek-v2-lite-16b.prefill_32k",
         "hymba": "hymba-1.5b.long_500k",
         "hymba_prefill": "hymba-1.5b.prefill_32k"}


def overrides(which: str, deep: bool = False, **extra) -> dict:
    """``harness.execute``'s overrides for the small stand-in of a cell;
    ``deep``: at the configuration's published depth (the control's
    error grows with depth as it does at full width)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    if which == "deepseek":
        cfg = get_config("deepseek-v2-lite-16b-smoke")
        n = 4
        m, e = cfg.mla, cfg.moe
        conf = {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
                "intermediate_size": e.dense_d_ff,
                "moe_intermediate_size": e.expert_d_ff,
                "n_shared_experts": e.shared_d_ff // e.expert_d_ff,
                "num_experts_per_tok": e.top_k,
                "first_k_dense_replace": e.first_dense_layers,
                "kv_lora_rank": m.kv_lora_rank,
                "qk_nope_head_dim": m.qk_nope_head_dim,
                "qk_rope_head_dim": m.qk_rope_head_dim,
                "v_head_dim": m.v_head_dim,
                "num_attention_heads": cfg.num_heads // n,
                "num_key_value_heads": cfg.num_kv_heads // n,
                "n_routed_experts": e.num_experts // n,
                "vocab_size": cfg.padded_vocab() // n,
                "published": {"num_attention_heads": cfg.num_heads,
                              "num_key_value_heads": cfg.num_kv_heads,
                              "n_routed_experts": e.num_experts,
                              "vocab_size": cfg.vocab_size}}
        traffic = {"batch": 2, "prompt_len": 64, "warmup": 1,
                   "trace_seconds": 0.5}
    else:
        cfg = get_config("hymba-1.5b-smoke")
        n = 16
        conf = {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
                "intermediate_size": cfg.d_ff,
                "num_attention_heads": cfg.num_heads,
                "num_key_value_heads": cfg.num_kv_heads,
                "head_dim": cfg.head_dim, "ssm_head_dim": cfg.ssm.head_dim,
                "mamba_d_state": cfg.ssm.d_state, "mamba_d_conv": cfg.ssm.d_conv,
                "mamba_expand": cfg.ssm.expand,
                "ssm_chunk": cfg.ssm.chunk_size,
                "sliding_window": cfg.sliding_window,
                "as_run": {"global_attn_idx": [0, cfg.num_layers - 1],
                           "tie_word_embeddings": False},
                "vocab_size": cfg.padded_vocab() // n,
                "published": {"vocab_size": cfg.vocab_size}}
        traffic = ({"batch": 1, "cache_slots": 96, "prefix": 80,
                    "warmup": 2, "trace_seconds": 0.5} if which == "hymba"
                   else {"batch": 2, "prompt_len": 64, "warmup": 1,
                         "trace_seconds": 0.5})
    conf.update(mesh={"shape": [1, n], "axes": ["data", "model"]},
                share={"model_rank": n - 1})
    if deep:
        depth = get_config(cfg.name[:-len("-smoke")]).num_layers
        cfg = dataclasses.replace(cfg, num_layers=depth)
        conf["num_hidden_layers"] = depth
        if which != "deepseek":
            conf["as_run"] = {**conf["as_run"],
                              "global_attn_idx": [0, 16, depth - 1]}
    out = {"cfg": cfg, "conf": conf, "traffic": traffic}
    for key, val in extra.items():
        out[key] = {**out.get(key, {}), **val} if isinstance(val, dict) \
            else val
    return out


def run(which: str, seed: int = 7, seconds: float = 0.3, trace=False,
        **extra) -> dict:
    """One run of the stand-in on the CPU, as ``run.py`` would run it
    (but for the look for a chip)."""
    torch.manual_seed(0)
    return harness.execute(CELLS[which], seed, seconds, trace,
                           t_start=time.time(), device="cpu",
                           overrides=overrides(which, **extra))
