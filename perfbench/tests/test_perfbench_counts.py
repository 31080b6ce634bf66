"""The yardstick's counts against what ``torch.utils.flop_counter``
counts in the plain reference run whole (a ``model`` axis of one), at
tiny widths: the prefill's and the decode step's operations."""
import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts, harness
from perfbench.reference import common
from perfbench.tests import smoke


def _whole(which):
    """The stand-in's configuration, params and share held whole."""
    ov = smoke.overrides(which)
    conf = dict(harness.open_cell(smoke.CELLS[which], ov).conf)
    conf.update(conf.get("published", {}))
    conf["published"] = {}
    conf["mesh"] = {"shape": [1, 1], "axes": ["data", "model"]}
    conf["share"] = {"model_rank": 0}
    conf["capacity_factor"] = 100.0         # no assignment dropped
    share = harness.build_share(conf, torch.device("cpu"), ov["cfg"])
    params = harness.draw_params(share, 5)
    return conf, share, params, {"n": 1, "rank": 0, "lo": 0}


def _counted(fn, monkeypatch, module):
    # one query row a block: the reference then scores the causal pairs
    # alone, as the count does
    monkeypatch.setattr(module, "attend",
                        functools.partial(common.attend, block=1))
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_prefill_count(monkeypatch):
    from perfbench.reference import deepseek_v2_lite_16b as ref
    conf, share, params, info = _whole("deepseek")
    b, s = 2, 24
    toks = torch.randint(0, conf["vocab_size"], (b, s))
    got = _counted(lambda: ref.prefill(params, conf, info, toks), monkeypatch,
                   ref)
    head = 2 * conf["hidden_size"] * conf["vocab_size"]
    # the reference's logits are the last position's alone
    want = counts.prefill_flops(conf, b, s) - b * (s - 1) * head
    assert got == want


def test_decode_count(monkeypatch):
    from perfbench.reference import hymba_1_5b as ref
    conf, share, params, info = _whole("hymba")
    cfg = share.cfg
    nl, slots, pos = cfg.num_layers, 48, 40
    di = cfg.ssm.d_inner(cfg.d_model)
    caches = [{"k": torch.randn(1, slots, cfg.num_kv_heads, cfg.head_dim),
               "v": torch.randn(1, slots, cfg.num_kv_heads, cfg.head_dim),
               "conv": torch.randn(1, cfg.ssm.d_conv - 1,
                                   di + 2 * cfg.ssm.d_state),
               "ssm": torch.randn(1, cfg.ssm.n_heads(cfg.d_model),
                                  cfg.ssm.head_dim, cfg.ssm.d_state)}
              for _ in range(nl)]
    toks = torch.randint(0, conf["vocab_size"], (1, 3))
    got = _counted(lambda: ref.decode(params, conf, info, caches, toks, pos),
                   monkeypatch, ref)
    # the elementwise part of the SSM step is not a product the counter
    # sees; its read-out is
    elementwise = nl * (counts.ssm_token_flops(conf)
                        - counts.ssm_readout_flops(conf))
    want = sum(counts.decode_flops(conf, 1, pos + t) - elementwise
               for t in range(3))
    assert got == want
