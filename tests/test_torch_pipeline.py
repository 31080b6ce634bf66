"""The port's pipeline over a ``stage`` mesh axis against the JAX
package, and ``run_peers``' failure paths.

``test_parallelism.py::test_pipeline_parallel_matches_sequential`` on 4
gloo ranks (``run_peers``, one spawn): 4 stages of ``tanh(x @ w + b)``
over 8 microbatches of 4 x 16 from seed 0, every rank's output within
1e-5 of the JAX sequential stack. In place of the reference's HLO check
for collective-permutes, each stage's activation sends are counted: one
per tick.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as R
from repro.train import pipeline_parallel as JP
from repro_torch.launch.mesh import PeerError, run_peers
from repro_torch.train.pipeline_parallel import (bubble_fraction,
                                                 stage_params_spec)

N_STAGES, N_MICRO, D = 4, 8, 16


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(N_STAGES, D, D)) * 0.5).astype(np.float32)
    bs = (rng.normal(size=(N_STAGES, D)) * 0.1).astype(np.float32)
    xs = rng.normal(size=(N_MICRO, 4, D)).astype(np.float32)
    got = run_peers(R.pipeline_case, N_STAGES, device="cpu", timeout_s=120,
                    args=(ws, bs, xs))
    want = jnp.asarray(xs)
    for s in range(N_STAGES):
        want = jnp.tanh(want @ jnp.asarray(ws[s]) + jnp.asarray(bs[s]))
    return got, np.asarray(want)


def test_pipeline_parallel_matches_sequential(case):
    got, want = case
    for r in got:
        assert r["got"].shape == want.shape
        assert float(np.abs(r["got"] - want).max()) < 1e-5


def test_pipeline_sends_one_activation_a_tick(case):
    got, _ = case
    ticks = N_MICRO + N_STAGES - 1
    assert [r["sends"] for r in got] == [ticks] * N_STAGES


def test_bubble_fraction_and_stage_spec_match_the_reference():
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9
    for s, m in ((1, 1), (2, 8), (4, 8), (8, 3)):
        assert bubble_fraction(s, m) == JP.bubble_fraction(s, m)
    one = {"w": np.zeros((D, D)), "b": np.zeros(D)}
    want = jax.tree.map(tuple, JP.stage_params_spec(one),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))
    assert stage_params_spec(one) == want


def test_run_peers_raises_when_a_rank_fails():
    """A rank that raises while the other waits in a collective fails
    the call in seconds, with the rank's traceback; the other is
    killed."""
    t = time.monotonic()
    with pytest.raises(PeerError, match="rank 1 fails on purpose"):
        run_peers(R.fail_case, 2, device="cpu", timeout_s=60)
    assert time.monotonic() - t < 45


def test_run_peers_raises_when_a_rank_hangs():
    """A rank that never joins a collective: the call raises once the
    timeout passes (the waiting rank's own group timeout, or run_peers'),
    never hangs."""
    t = time.monotonic()
    with pytest.raises(PeerError):
        run_peers(R.hang_case, 2, device="cpu", timeout_s=5)
    assert time.monotonic() - t < 45
