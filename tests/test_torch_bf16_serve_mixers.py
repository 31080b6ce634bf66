"""bf16 serving of the port against the JAX package in bf16, on the CPU,
for the SSM, hybrid, MoE + MLA and enc-dec families the card serves in
bf16 (their smoke configs): the checks, weights, inputs and tolerance of
``test_torch_bf16_serve.py`` (``tests/_torch_bf16.py``), twice the
reference's own bf16-against-f32 gap ``g``.
"""
import pytest

from _torch_bf16 import (check_cell_counts, check_forward, check_steps,
                         gap_by_depth)

ARCHS = ["tiny-ssm", "hymba-1.5b-smoke", "deepseek-v2-lite-16b-smoke",
         "seamless-m4t-large-v2-smoke"]


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


@pytest.mark.parametrize("layers", [1, 12])
def test_mamba2_bf16_gap_within_twice_the_reference_s_own(layers):
    """mamba2-370m at full width, cut to ``layers`` of its 48 layers, 256
    tokens: the port's bf16-against-f32 gap, which chip_smoke.py's phase
    29 takes as its limit at full depth, is within twice the reference's
    own on the same weights."""
    ref, port, scale = gap_by_depth("mamba2-370m", layers, 256)
    assert 0 < port <= 2 * ref, (layers, port, ref, scale)
