"""qwen3-4b  [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm, GQA, head_dim=128 (explicit; 32*128 != d_model).
[hf:Qwen/Qwen3-8B family; hf-verified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=9728,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
