"""hymba-1.5b  [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16. Parallel attention + mamba heads per layer.
[arXiv:2411.13676; hf-verified]

Hybrid-head module: attention heads and SSM heads process the same input
in parallel; outputs are RMS-normalized and averaged. Most layers use
sliding-window attention (window 1024); every 16th layer (and the first)
is global. SSM path + SWA => sub-quadratic => runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    head_dim=64,
    attention_kind="swa",
    sliding_window=1024,
    global_attn_every=16,
    hybrid_parallel_heads=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
)
