"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Ten assigned architectures + reduced smoke variants (``<id>-smoke``) and a
couple of tiny configs used by examples/tests, and the dry-run's (arch x
shape) cells.
"""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_v2_lite_16b,
    hymba_1_5b,
    mamba2_370m,
    phi3_5_moe_42b,
    qwen1_5_32b,
    qwen2_5_3b,
    qwen2_vl_7b,
    qwen3_4b,
    seamless_m4t_large_v2,
    tinyllama_1_1b,
)
from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SHAPES, ShapeConfig, SSMConfig, reduce_for_smoke,
)

ARCHS = {
    "qwen3-4b": qwen3_4b.CONFIG,
    "qwen1.5-32b": qwen1_5_32b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "tinyllama-1.1b": tinyllama_1_1b.CONFIG,
    "mamba2-370m": mamba2_370m.CONFIG,
    "qwen2-vl-7b": qwen2_vl_7b.CONFIG,
    "seamless-m4t-large-v2": seamless_m4t_large_v2.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.CONFIG,
    "phi3.5-moe-42b": phi3_5_moe_42b.CONFIG,
}

# Sub-quadratic archs that run the long_500k cell.
LONG_CONTEXT_ARCHS = {"mamba2-370m", "hymba-1.5b"}

# ~100M dense model for the end-to-end training example.
TRAIN_100M = ModelConfig(
    name="train-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32_000,
    qk_norm=True,
    tie_embeddings=True,
)

# Tiny config for fast CPU examples / tests.
TINY = ModelConfig(
    name="tiny",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    qk_norm=True,
)

TINY_MOE = ModelConfig(
    name="tiny-moe",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=64),
)

TINY_SSM = ModelConfig(
    name="tiny-ssm",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    attention_kind="none",
    ssm=SSMConfig(d_state=16, head_dim=16, chunk_size=16),
)

_EXTRA = {"train-100m": TRAIN_100M, "tiny": TINY, "tiny-moe": TINY_MOE,
          "tiny-ssm": TINY_SSM}


def get_config(arch: str) -> ModelConfig:
    if arch.endswith("-smoke"):
        return reduce_for_smoke(get_config(arch[: -len("-smoke")]))
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in _EXTRA:
        return _EXTRA[arch]
    raise KeyError(
        f"unknown arch {arch!r}; known: {sorted(ARCHS) + sorted(_EXTRA)}")



def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_is_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether the (arch, shape) dry-run cell runs, and why not if skipped."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{arch} is full-attention (skip per assignment)")
    return True, ""


def all_cells() -> list:
    """All applicable (arch, shape) dry-run cells."""
    cells = []
    for arch in ARCHS:
        for shape in SHAPES:
            ok, _ = cell_is_applicable(arch, shape)
            if ok:
                cells.append((arch, shape))
    return cells
