"""The port's knob auto-sweep (``AutoTuner``, ``TuningGrid``,
``modeled_flush_seconds``) against the JAX package's, on the CPU.

The cases of ``tests/test_autotune.py::TestAutoTuner`` run on the port
(``device="cpu"`` engines): memoised trials, the result landing in
``engine.stats["autotune"]``, same-seed determinism, counts (not wall
time) driving the score, and the ``autotune_*`` terms of
``predict_from_stats``. Then the port's whole sweep is held against the
JAX tuner's on the same live traffic — every trial's ``(tuning.key(),
flushes, wqes, score)`` equal (scores with ``==``), the same chosen
point, improvement and trial count — at the reference bench's geometry
(seed 7, 2^12 words, 2 passes, 128 rows) and at another seed and grid.
The trials make no QDMA staging writes, so the executor profile does not
enter the score: the port's own H100 profile and the reference's
constants choose the same point. Trial engines sit on the live engine's
device and dtype.
"""
import numpy as np
import pytest

import repro.core.rdma as J
import repro_torch.core.rdma as T
import repro_torch.core.rdma.engine as t_engine
from repro.core.rdma.autotune import modeled_flush_seconds as j_modeled
from repro.core.rdma.cost_model import XLA_COST
from repro_torch.core.rdma.autotune import (AutoTuner, TransportTuning,
                                            TuningGrid,
                                            modeled_flush_seconds)
from repro_torch.core.rdma.cost_model import EXECUTOR_COST, ExecutorCost
from repro_torch.core.rdma.simulator import predict_from_stats

POOL = 4096

SMALL_GRID = TuningGrid(ring_burst=(16, 32), pipeline_depth=(1, 2),
                        flush_budget=(None,), qp_window=(None,))


def _engine(**kw):
    kw.setdefault("n_peers", 2)
    kw.setdefault("pool_size", POOL)
    kw.setdefault("device", "cpu")
    return T.RDMAEngine(**kw)


def _post_reads(eng, qp, mr, lengths, rng=None):
    rng = rng or np.random.default_rng(0)
    for i, ln in enumerate(lengths):
        eng.post_send(qp, T.WQE(
            T.Opcode.READ, qp.qp_num, wr_id=i,
            local_addr=int(rng.integers(0, POOL // 4 - ln)),
            remote_addr=int(rng.integers(0, POOL // 4 - ln)),
            length=int(ln), rkey=mr.rkey))


class TestAutoTuner:
    """``tests/test_autotune.py::TestAutoTuner`` on the port."""

    def _live_engine(self):
        eng = _engine()
        mr = eng.register_mr(1, 0, 1024)
        qp = eng.create_qp(0, 1)
        _post_reads(eng, qp, mr, [7, 20, 33])
        eng.ring_sq_doorbell(qp)
        return eng

    def test_trials_are_memoized_per_point(self):
        eng = self._live_engine()
        tuner = AutoTuner(eng, grid=SMALL_GRID, seed=3, passes=1, rows=16)
        a = tuner.measure(TransportTuning())
        b = tuner.measure(TransportTuning())
        assert a is b
        assert len(tuner.surface) == 1

    def test_sweep_result_lands_in_engine_stats(self):
        eng = self._live_engine()
        tuner = AutoTuner(eng, grid=SMALL_GRID, seed=3, passes=1, rows=16)
        chosen = tuner.sweep()
        at = eng.stats["autotune"]
        assert at["chosen"] == chosen.as_dict()
        assert at["seed"] == 3
        assert at["trials"] == len(at["surface"]) == len(tuner.surface)
        assert at["score"] >= at["default_score"]          # grid holds
        assert at["improvement"] >= 1.0 - 1e-9             # the default
        assert eng.tuning == chosen          # sweep() applied it

    def test_same_seed_sweeps_choose_identically(self):
        eng = self._live_engine()
        c1 = AutoTuner(eng, grid=SMALL_GRID, seed=5, passes=1,
                       rows=16).sweep(apply=False)
        c2 = AutoTuner(eng, grid=SMALL_GRID, seed=5, passes=1,
                       rows=16).sweep(apply=False)
        assert c1 == c2

    def test_trial_counts_not_wallclock_drive_the_score(self):
        eng = self._live_engine()
        tuner = AutoTuner(eng, grid=SMALL_GRID, seed=3, passes=1, rows=16)
        res = tuner.measure(TransportTuning())
        assert res.score == pytest.approx(res.rows / res.modeled_s)
        assert res.modeled_s > 0 and res.wall_s > 0
        assert res.flushes > 0 and res.wqes > 0

    def test_predict_from_stats_threads_autotune_terms(self):
        eng = self._live_engine()
        AutoTuner(eng, grid=SMALL_GRID, seed=3, passes=1, rows=16).sweep()
        out = predict_from_stats(eng.stats, payload=128)
        assert out["autotune_trials"] >= 3
        assert out["autotune_improvement"] >= 1.0 - 1e-9
        assert out["autotune_chosen_ring_burst"] in (16.0, 32.0)
        assert out["learned_buckets"] >= 1.0

    def test_stats_without_autotune_have_no_terms(self):
        eng = self._live_engine()
        out = predict_from_stats(eng.stats, payload=128)
        assert "autotune_trials" not in out
        assert out["learned_buckets"] >= 1.0  # learner always observes


# ---------------------------------------------------------------------------
# the whole sweep against the JAX tuner
# ---------------------------------------------------------------------------

def _bench_live(side, seed, pool=POOL, **kw):
    """A live engine with the reference bench's traffic profile: eight
    host READs of 8..47 words, one doorbell (bench_autotune.py)."""
    eng = side.RDMAEngine(n_peers=2, pool_size=pool, **kw)
    mr = eng.register_mr(1, 0, pool // 4)
    qp = eng.create_qp(0, 1)
    rng = np.random.default_rng(seed)
    for i in range(8):
        ln = int(rng.integers(8, 48))
        eng.post_send(qp, side.WQE(
            side.Opcode.READ, qp.qp_num, wr_id=i,
            local_addr=int(rng.integers(0, pool // 4 - ln)),
            remote_addr=int(rng.integers(0, pool // 4 - ln)),
            length=ln, rkey=mr.rkey))
    eng.ring_sq_doorbell(qp)
    return eng


def _surface(tuner):
    return [(r.tuning.key(), r.flushes, r.wqes, r.modeled_s, r.score)
            for r in tuner.surface]


def _result(tuner):
    return {k: v for k, v in tuner.result.items() if k != "surface"}


OTHER_GRID = TuningGrid(ring_burst=(4, 32, 48), pipeline_depth=(1, 3),
                        flush_budget=(None, 6, 24), qp_window=(None, 2, 12))


@pytest.mark.parametrize("seed,grid,passes,rows,scheduler", [
    (7, None, 2, 128, "rr"),            # the reference bench's sweep
    (11, OTHER_GRID, 1, 96, "drr"),
])
def test_sweep_surface_equals_the_jax_tuner(seed, grid, passes, rows,
                                            scheduler):
    kw = dict(seed=seed, grid=grid, passes=passes, rows=rows)
    jeng = _bench_live(J, seed, scheduler=scheduler)
    jtuner = J.AutoTuner(jeng, **kw)
    jchosen = jtuner.sweep(apply=False)
    for executor in (XLA_COST, EXECUTOR_COST):
        teng = _bench_live(T, seed, scheduler=scheduler, device="cpu")
        tuner = T.AutoTuner(teng, executor=executor, **kw)
        chosen = tuner.sweep(apply=False)
        assert chosen.as_dict() == jchosen.as_dict()
        assert _surface(tuner) == _surface(jtuner)
        assert _result(tuner) == _result(jtuner)
        assert teng.tuning == TransportTuning()      # apply=False
    if seed == 7:
        # BENCH_autotune.json: burst 64, depth 4, 15 trials
        assert (jchosen.ring_burst, jchosen.pipeline_depth) == (64, 4)
        assert jtuner.result["trials"] == 15


def test_second_sweep_reproduces_the_first_surface():
    """The port keeps no process-wide compile cache to count, so the
    reference bench's zero-new-compiles check becomes: a second sweep
    from a fresh tuner gives the same surface and choice."""
    eng = _bench_live(T, 7, device="cpu")
    t1 = AutoTuner(eng, seed=7, passes=2, rows=128)
    c1 = t1.sweep(apply=False)
    t2 = AutoTuner(eng, seed=7, passes=2, rows=128)
    assert t2.sweep(apply=False) == c1
    assert _surface(t2) == _surface(t1)
    eng.apply_tuning(c1)
    assert eng.tuning == c1


def test_trial_engines_follow_the_live_engine(monkeypatch):
    """Every trial engine is built on the live engine's device and dtype
    (never the ``device=None`` GPU default)."""
    built = []

    class Recording(t_engine.RDMAEngine):
        def __init__(self, *a, **kw):
            built.append(kw)
            super().__init__(*a, **kw)

    eng = _engine(dtype=np.float64)
    monkeypatch.setattr(t_engine, "RDMAEngine", Recording)
    tuner = AutoTuner(eng, grid=SMALL_GRID, seed=3, passes=1, rows=16)
    tuner.sweep(apply=False)
    assert len(built) == len(tuner.surface) == 3
    for kw in built:
        assert str(kw["device"]) == "cpu"
        assert np.dtype(kw["dtype"]) == np.float64
    assert all(r.flushes > 0 for r in tuner.surface)


@pytest.mark.parametrize("qdma", [0, 3])
def test_modeled_flush_seconds_prices_counts(qdma):
    """Bit-equal to the reference's under its constants; the executor
    profile enters only through QDMA staging writes."""
    for payload, loc in ((256, "dev_mem"), (4096, "host_mem")):
        args = (7, 93, qdma)
        got = modeled_flush_seconds(*args, payload=payload, qp_location=loc,
                                    executor=XLA_COST)
        assert got == j_modeled(*args, payload=payload, qp_location=loc)
        other = modeled_flush_seconds(
            *args, payload=payload, qp_location=loc,
            executor=ExecutorCost(compile_s=1.0, dispatch_s=1.0,
                                  staging_dispatch_s=0.5))
        assert (other == got) == (qdma == 0)
