"""qwen1.5-32b  [dense] — 64L d_model=5120 40H (GQA kv=40 = MHA) d_ff=27392
vocab=152064. QKV bias.  [hf:Qwen/Qwen1.5 family; hf-verified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27_392,
    vocab_size=152_064,
    head_dim=128,
    qk_norm=False,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
