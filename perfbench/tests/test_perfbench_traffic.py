"""The traffic is a function of the seed: the same seed draws the same
inputs, another seed other ids of the same sizes, all among the share's
vocabulary rows."""
import pytest
import torch

from perfbench import harness
from perfbench.tests import smoke
from perfbench.traffic import generator


def _share(which):
    ov = smoke.overrides(which)
    conf = harness.open_cell(smoke.CELLS[which], ov).conf
    return harness.build_share(conf, torch.device("cpu"), ov["cfg"]), ov


def test_prompts_follow_the_seed():
    share, ov = _share("deepseek")
    tr = ov["traffic"]
    a = generator.prompts(tr, share, 3_000_000_123, 5)
    b = generator.prompts(tr, share, 3_000_000_123, 5)
    c = generator.prompts(tr, share, 3_000_000_124, 5)
    d = generator.prompts(tr, share, 3_000_000_123, 6)
    assert torch.equal(a, b)
    assert a.shape == c.shape == (tr["batch"], tr["prompt_len"])
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert int(a.min()) >= share.lo and int(a.max()) < share.hi


def test_session_tokens_follow_the_seed():
    share, ov = _share("hymba")
    tr = ov["traffic"]
    a = generator.first_tokens(tr, share, 11)
    assert torch.equal(a, generator.first_tokens(tr, share, 11))
    assert a.shape == (tr["batch"], 1)
    assert share.lo <= int(a.min()) and int(a.max()) < share.hi


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 3_000_000_001])
def test_weights_follow_the_seed(seed):
    share, _ = _share("deepseek")
    a = harness.draw_params(share, seed)
    b = harness.draw_params(share, seed)
    for (pa, x), (pb, y) in zip(harness.leaves(a), harness.leaves(b)):
        assert pa == pb and torch.equal(x, y)
    other = harness.draw_params(share, seed + 1)
    assert not torch.equal(a["embed"], other["embed"])
