"""seamless-m4t-large-v2  [audio] — 24L d_model=1024 16H (kv=16) d_ff=8192
vocab=256206. Encoder-decoder, multimodal.  [arXiv:2308.11596; hf-verified]

Backbone only: the speech frontend (w2v-BERT conformer) is a STUB —
``input_specs()`` provides precomputed frame embeddings for the encoder.
24 encoder layers + 24 decoder layers (self + cross attention).
Shape cells: S_dec = seq_len, S_enc = seq_len / encoder_seq_ratio.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    head_dim=64,
    enc_dec=True,
    encoder_layers=24,
    encoder_seq_ratio=4,
    embedding_frontend_stub=True,
)
