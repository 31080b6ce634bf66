"""The comparison that decides ``correct`` fails what it must: a run of
each cell's small stand-in with the timed path broken underneath (the
serve step patched) comes out not correct, once for each fault the
cell can have, and so does the control, the plain reference in float8
in the program's place (``calibrate.readings``), in a stand-in at the
configuration's published depth. The cells run on one chip with no
exchange between chips, so that fault has no place here.
"""
import copy

import pytest

from perfbench import calibrate
from perfbench.tests import smoke


def _copy_caches(caches):
    return copy.deepcopy(caches)


def prefill_state_unchanged(real):
    """The prefill writes into a copy: the caches keep their state."""
    def step(params, cfg, batch, caches, tp=None):
        return real(params, cfg, batch, _copy_caches(caches), tp=tp)
    return step


def _first(caches, half: int):
    """Views of the caches' first ``half`` sequences (the stacked
    ``scan`` leaves hold the batch on dim 1, the dense blocks' on 0)."""
    def cut(tree, dim):
        if isinstance(tree, dict):
            return {k: cut(v, dim) for k, v in tree.items()}
        return tree.narrow(dim, 0, half) if tree.dim() > dim else tree
    return {k: cut(v, 1 if k == "scan" else 0) for k, v in caches.items()}


def prefill_half_batch(real):
    """Only the first half of the batch is run, into its half of the
    caches; its logits stand for the rest."""
    def step(params, cfg, batch, caches, tp=None):
        toks = batch["tokens"]
        half = toks.shape[0] // 2
        logits, _ = real(params, cfg, {"tokens": toks[:half]},
                         _first(caches, half), tp=tp)
        return logits.repeat(toks.shape[0] // half, 1, 1), caches
    return step


def prefill_answer_altered(real):
    """The logits come back altered where the step produces them."""
    def step(params, cfg, batch, caches, tp=None):
        logits, caches = real(params, cfg, batch, caches, tp=tp)
        return -logits, caches
    return step


def decode_state_unchanged(real):
    def step(params, cfg, tokens, caches, pos, extra=None, tp=None):
        return real(params, cfg, tokens, _copy_caches(caches), pos, extra,
                    tp=tp)
    return step


def decode_token_altered(real):
    """The step's best token is pushed below every other."""
    def step(params, cfg, tokens, caches, pos, extra=None, tp=None):
        logits, caches = real(params, cfg, tokens, caches, pos, extra, tp=tp)
        top = logits.argmax(-1, keepdim=True)
        return logits.scatter(-1, top, logits.amin(-1, keepdim=True) - 1), \
            caches
    return step


@pytest.mark.parametrize("which,name,fault", [
    ("deepseek", "prefill_step", prefill_state_unchanged),
    ("deepseek", "prefill_step", prefill_half_batch),
    ("deepseek", "prefill_step", prefill_answer_altered),
    ("hymba_prefill", "prefill_step", prefill_state_unchanged),
    ("hymba_prefill", "prefill_step", prefill_half_batch),
    ("hymba_prefill", "prefill_step", prefill_answer_altered),
    ("hymba", "decode_step", decode_state_unchanged),
    ("hymba", "decode_step", decode_token_altered)])
def test_fault_is_not_correct(which, name, fault, monkeypatch):
    from repro_torch.serve import serve_step
    monkeypatch.setattr(serve_step, name, fault(getattr(serve_step, name)))
    out = smoke.run(which, seed=19)
    assert not out["correct"], out["checked"]


@pytest.mark.parametrize("which", ["deepseek", "hymba", "hymba_prefill"])
def test_control_is_not_correct(which):
    from perfbench import harness
    limits = harness.load_json(harness.HERE / "limits"
                               / f"{smoke.CELLS[which]}.json")["numbers"]
    (r,) = calibrate.readings(smoke.CELLS[which], 0.2, [23], [23],
                              device="cpu",
                              overrides=smoke.overrides(which, deep=True))
    assert any(r["control"][k] > v["limit"] for k, v in limits.items()), \
        r["control"]
