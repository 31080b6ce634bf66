"""Configuration system of the PyTorch port (a copy of the reference's
``configs/base.py``: plain data, no framework).

Plain dataclasses (no external deps). One ``ModelConfig`` covers every
assigned architecture family: dense GQA transformers, SSM (mamba2/SSD),
hybrid attn+SSM (hymba), MoE (classic + MLA), encoder-decoder (seamless),
and VLM backbones (qwen2-vl M-RoPE). Architecture files in this package
instantiate exact published configs; ``registry.py`` exposes ``get_config``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    num_experts: int = 0              # routed experts
    num_shared_experts: int = 0       # always-on experts (deepseek style)
    top_k: int = 0
    expert_d_ff: int = 0              # per-expert FFN hidden dim
    shared_d_ff: int = 0              # shared-expert FFN hidden dim (total)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.001
    first_dense_layers: int = 0       # leading dense layers (deepseek: 1)
    dense_d_ff: int = 0               # d_ff used by those dense layers

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2) configuration."""
    kv_lora_rank: int = 0             # compressed KV dim (c_kv)
    q_lora_rank: int = 0              # 0 => direct q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) configuration."""
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2                   # d_inner = expand * d_model
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    @property
    def enabled(self) -> bool:
        return self.d_state > 0

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | ssm | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # attention pattern
    attention_kind: str = "full"      # full | swa | none (ssm-only)
    sliding_window: int = 0           # used when attention_kind == "swa"
    global_attn_every: int = 0        # hybrid-swa: every k-th layer is global
    # family extensions
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid_parallel_heads: bool = False   # hymba: attn + SSM heads in parallel
    # encoder-decoder (seamless)
    encoder_layers: int = 0
    enc_dec: bool = False
    encoder_seq_ratio: int = 4        # S_enc = S / ratio for shape cells
    # VLM (qwen2-vl)
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)   # t, h, w halves of head_dim/2
    vision_patches_ratio: int = 4     # n_patches = S / ratio for shape cells
    # frontend stub: inputs are precomputed embeddings instead of token ids
    embedding_frontend_stub: bool = False

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab padded for TP divisibility (embedding/logits tables only;
        ``param_count`` and labels use the true vocab)."""
        return -(-self.vocab_size // multiple) * multiple

    def resolved_head_dim(self) -> int:
        if self.mla.enabled:
            return self.mla.qk_head_dim
        if self.num_heads == 0:          # attention-free (ssm)
            return 0
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim()

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim()

    # ---- parameter counting (for roofline MODEL_FLOPS) -------------------
    def param_count(self) -> int:
        """Total parameter count (embedding included)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Active-per-token parameters (MoE: shared + top_k experts)."""
        return _param_count(self, active_only=True)


def _ffn_params(d_model: int, d_ff: int) -> int:
    # gated (SwiGLU) FFN: up, gate, down
    return 3 * d_model * d_ff


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    if cfg.mla.enabled:
        m = cfg.mla
        p = d * cfg.num_heads * m.qk_head_dim                 # W_q
        p += d * (m.kv_lora_rank + m.qk_rope_head_dim)        # W_dkv + W_kr
        p += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
        p += cfg.num_heads * m.v_head_dim * d                 # W_o
        return p
    q = d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    b = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + b


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    # in_proj -> [z, x, B, C, dt], conv, A, D, norm, out_proj
    proj_in = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
    conv = (di + 2 * s.n_groups * s.d_state) * s.d_conv
    return proj_in + conv + 2 * nh + di + di * d


def _layer_params(cfg: ModelConfig, layer_idx: int, active_only: bool) -> int:
    p = 2 * cfg.d_model  # two RMSNorms
    if cfg.family == "ssm":
        return p + _ssm_params(cfg) + 0  # mamba2 blocks have no separate FFN here
    mix = _attn_params(cfg)
    if cfg.hybrid_parallel_heads:
        mix += _ssm_params(cfg)
    if cfg.moe.enabled and layer_idx >= cfg.moe.first_dense_layers:
        m = cfg.moe
        routed = (m.top_k if active_only else m.num_experts) * _ffn_params(cfg.d_model, m.expert_d_ff)
        shared = _ffn_params(cfg.d_model, m.shared_d_ff) if m.shared_d_ff else 0
        router = cfg.d_model * m.num_experts
        ffn = routed + shared + router
    else:
        d_ff = cfg.moe.dense_d_ff if (cfg.moe.enabled and cfg.moe.dense_d_ff) else cfg.d_ff
        ffn = _ffn_params(cfg.d_model, d_ff)
    return p + mix + ffn


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    total = cfg.vocab_size * cfg.d_model       # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model  # lm head
    total += cfg.d_model                       # final norm
    for i in range(cfg.num_layers):
        total += _layer_params(cfg, i, active_only)
    if cfg.enc_dec:
        # encoder layers: self-attn + ffn; decoder already counted above and
        # gains cross-attention.
        for _ in range(cfg.encoder_layers):
            total += 2 * cfg.d_model + _attn_params(cfg) + _ffn_params(cfg.d_model, cfg.d_ff)
        total += cfg.num_layers * (_attn_params(cfg) + cfg.d_model)  # cross-attn + norm
    return total


# ---------------------------------------------------------------------------
# Shapes (the four assigned input-shape cells)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch   # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Mesh / runtime
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    shape: tuple = (16, 16)
    axes: tuple = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def dp_axes(self) -> tuple:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def tp_axis(self) -> str:
        return "model"


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    microbatches: int = 1             # gradient accumulation
    remat: bool = True                # checkpoint each layer
    zero1: bool = True                # shard optimizer state over data axis
    param_dtype: str = "float32"      # smoke tests use fp32; dry-run bf16
    compute_dtype: str = "bfloat16"
    # RecoNIC-derived distributed-optimization knobs
    grad_bucket_mb: float = 0.0       # 0 => XLA-native sync; >0 => doorbell-
    #                                   batched bucketed all-reduce
    compress_grads: bool = False      # streaming-compute int8 compression
    sequence_parallel: bool = True    # shard residual stream seq over 'model'


@dataclass(frozen=True)
class ServeConfig:
    max_seq_len: int = 32_768
    kv_dtype: str = "bfloat16"
    page_size: int = 256              # KV pages (RecoNIC memory regions)
    decode_batch: int = 128


@dataclass(frozen=True)
class RunConfig:
    """Top-level config: model + shape + mesh + train/serve settings."""
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = SINGLE_POD_MESH
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Reduced ("smoke") configs — same family, tiny dims, CPU-runnable
# ---------------------------------------------------------------------------

def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full config to a CPU-runnable config of the same family.

    Keeps every structural feature (GQA ratio, qk-norm, bias, MoE top-k,
    MLA, SSM, hybrid heads, enc-dec, M-RoPE) while shrinking dims.
    """
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        d_ff=128,
        vocab_size=256,
        head_dim=16 if cfg.head_dim else 0,
    )
    if cfg.moe.enabled:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=32,
            shared_d_ff=32 if cfg.moe.shared_d_ff else 0,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            dense_d_ff=64 if cfg.moe.dense_d_ff else 0,
        )
    if cfg.mla.enabled:
        kw["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16)
        kw["head_dim"] = 0
    if cfg.ssm.enabled:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=16)
    if cfg.enc_dec:
        kw["encoder_layers"] = 2
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    return dataclasses.replace(cfg, **kw)
