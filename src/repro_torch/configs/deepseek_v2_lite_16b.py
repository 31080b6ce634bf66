"""deepseek-v2-lite-16b  [moe] — 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MLA kv_lora=512, MoE top-6.  [arXiv:2405.04434; hf-verified]

Assignment note: the cell reads "MoE 64e top-6" and also "2 shared+160
routed"; 160 routed is the *full* V2 — V2-Lite (the 16B model named here)
has 64 routed + 2 shared, top-6, which we use. MLA: kv_lora_rank=512,
qk_nope=128, qk_rope=64, v=128, no q-lora (direct q projection in Lite).
Layer 0 is dense with d_ff=10944; shared-expert d_ff = 2*1408 = 2816.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,          # MLA: per-head latent KV (no GQA grouping)
    d_ff=10_944,              # dense-layer FFN width
    vocab_size=102_400,
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                  expert_d_ff=1408, shared_d_ff=2816,
                  first_dense_layers=1, dense_d_ff=10_944),
)
