"""bf16 serving of the port against the JAX package in bf16, on the CPU.

The JAX package's bf16 weights (``init_params(dtype=bfloat16)``) go
through ``params_from_jax``, so both packages serve the same bf16
values; token ids come from numpy seeds, and the frames and patches
beside them are the same bf16 values on both sides. For the attention
decoders the card serves in bf16 (their smoke configs; the other
families are in ``test_torch_bf16_serve_mixers.py``), the port's bf16
forward and its bf16 prefill + decode (on bf16 caches) are held against
the reference's in bf16.

Tolerance: twice ``g``, the reference's own gap between its bf16 and its
f32 forward on the same weights (widened exactly) and inputs, at the
positions compared. Two bf16 routes round at other places (the matmuls
sum in another order, so some products land on the other side of a bf16
rounding step, and the difference grows through the layers), so neither
lies closer to the other than bf16 itself allows; ``g`` measures that in
each case, and is never tuned.

The meta trace: a bf16 cell at reduced length counts the same FLOPs,
bytes and kernel charges on ``meta`` as on the CPU.
"""
import pytest

from _torch_bf16 import check_cell_counts, check_forward, check_steps

ARCHS = ["tiny", "qwen2-vl-7b-smoke", "qwen3-4b-smoke", "qwen2.5-3b-smoke"]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_within_twice_the_reference_bf16_gap(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_decode_within_twice_the_reference_bf16_gap(arch):
    check_steps(arch)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_cell_counts_the_same_on_meta_and_cpu(arch, kind):
    check_cell_counts(arch, kind)
