"""qwen2-vl-7b  [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064. M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf-verified]

Backbone only: the vision tower is a STUB — ``input_specs()`` provides
precomputed patch embeddings merged into the token stream, plus 3D
(t, h, w) M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope=True,
    mrope_sections=(16, 24, 24),
    vision_patches_ratio=4,
)
