"""The one generator of the benchmark's traffic: what a mix's file of
parameters (``traffic/<name>.json``) asks for, drawn from the run's
seed on the device.

Every operation's inputs come from ``seed`` and the operation's index
alone, so a run and its reference draw the same ones, and two seeds
draw the same sizes (the work a seed sets is the same; only the token
ids differ). Token ids lie among the vocabulary rows the share holds,
``[lo, hi)``: the share's all-reduce adds no other rank's rows, so a
token outside them would embed to zero.

Keys of a mix:
  kind          ``prefill`` or ``decode``: the driver in ``kinds/``
  batch         sequences an operation carries
  prompt_len    (prefill) tokens of each fresh prompt, from position 0
  cache_slots   (decode) positions each sequence's cache holds
  prefix        (decode) positions already in the cache when a session
                starts: the cache is seeded, as a long document's
  warmup        operations run once in set-up, on inputs of the same
                shapes (not the window's)
  trace_seconds the window of a traced run
"""
from __future__ import annotations

import torch

from perfbench.harness import seed_of


def token_ids(shape, lo: int, hi: int, seed: int, *tags,
              device=None) -> torch.Tensor:
    """int64 ids uniform in ``[lo, hi)`` of ``shape``, from ``seed`` and
    ``tags``, drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, *tags))
    return torch.randint(lo, hi, tuple(shape), generator=gen, device=device)


def prompts(traffic: dict, share, seed: int, op: int) -> torch.Tensor:
    """Operation ``op``'s fresh prompts, (batch, prompt_len); warm-up
    operations are negative."""
    return token_ids((traffic["batch"], traffic["prompt_len"]), share.lo,
                     share.hi, seed, "prompt", op, device=share.device)


def first_tokens(traffic: dict, share, seed: int) -> torch.Tensor:
    """A decode session's first input tokens, (batch, 1)."""
    return token_ids((traffic["batch"], 1), share.lo, share.hi, seed,
                     "session", device=share.device)
