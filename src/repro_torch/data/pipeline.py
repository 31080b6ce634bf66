"""Deterministic synthetic data pipeline (sharded, skip-ahead restartable).

The port's own copy of ``repro/data/pipeline.py`` (plain numpy): it
yields the same batches, byte for byte, for every (seed, step).

Produces language-modeling batches from a seeded generator. Determinism is
keyed on (seed, step) only — after a failure/elastic resize, any host can
regenerate exactly the batch for step N (``skip-ahead restore``), which is
the property a real sharded loader (e.g. deterministic tfrecord sharding)
must provide for fault-tolerant training.

Structure mimics a production loader: host-side numpy generation ("the
network/storage path"), staged to device as the HOST_IO traffic class.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class DataConfig:
    seed: int = 0
    vocab_size: int = 32_000
    batch: int = 8
    seq_len: int = 128
    # synthetic task: token t+1 = (a*t + b) % vocab on segment boundaries,
    # giving a learnable structure (not pure noise) for loss-decrease tests
    structured: bool = True


class SyntheticPipeline:
    """Stateless, step-addressable batch source."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step]))
        if c.structured:
            a = rng.integers(1, 17, size=(c.batch, 1))
            b = rng.integers(0, c.vocab_size, size=(c.batch, 1))
            t = np.arange(c.seq_len + 1)[None, :]
            toks = (a * t + b) % c.vocab_size
        else:
            toks = rng.integers(0, c.vocab_size,
                                size=(c.batch, c.seq_len + 1))
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def resume_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        """Skip-ahead restore: identical stream from an arbitrary step."""
        while True:
            yield self.batch_at(step)
            step += 1


def input_batch_for(model: ModelConfig, shape: ShapeConfig,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Concrete (small-scale) batch matching a dry-run cell's structure —
    used by smoke tests; the dry-run itself uses ShapeDtypeStructs."""
    pipe = SyntheticPipeline(DataConfig(
        seed=seed, vocab_size=model.vocab_size,
        batch=min(shape.global_batch, 2),
        seq_len=min(shape.seq_len, 64)))
    return pipe.batch_at(0)
