"""tinyllama-1.1b  [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000. llama2-arch small.  [arXiv:2401.02385; hf-verified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32_000,
    head_dim=64,
    qk_norm=False,
    qkv_bias=False,
    rope_theta=10_000.0,
)
