"""mamba2-370m  [ssm] — 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128. SSD (state-space duality).  [arXiv:2405.21060]

d_inner = 2*d_model = 2048, head_dim 64 -> 32 SSD heads, conv width 4.
Attention-free => runs the long_500k cell (sub-quadratic).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    attention_kind="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    tie_embeddings=True,
)
