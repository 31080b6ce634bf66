"""The port's ``ICITransport`` twin and seed executors against the JAX
package.

The twin runs as gloo ranks on the CPU (``run_peers``: one spawn of four
ranks for the transport's cases, one of two for the Lookaside block's),
the reference's counterpart of its forced-device subprocesses; the JAX
side runs in this process on its ``LocalTransport`` (one CPU device), or
in a forced four-device subprocess where its ``ICITransport`` itself is
the point. Tolerances: pools byte-equal everywhere (compared as uint32
words, so ``-0.0`` and ``+0.0`` differ), the Lookaside matmul against
``ref_matmul`` within ``1e-5 * k / 128`` (two CPU dots may sum in
another order), byte-equal to the port's single-process run.

The reference's 8-peer READ fan-in (``test_distributed.py``) runs at 4
peers; the geometry is the only change.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as R
import repro.core.rdma as J
from repro.core.rdma import transport as JT
from repro.kernels import ref as jref
from repro_torch.launch.mesh import run_peers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SPAWN_TIMEOUT_S = 120


def _words(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def four():
    """Every rank's results of ``transport_cases`` (4 gloo ranks)."""
    return run_peers(R.transport_cases, 4, device="cpu",
                     timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def two():
    return run_peers(R.lookaside_case, 2, device="cpu",
                     timeout_s=SPAWN_TIMEOUT_S)


def _jax_local(init):
    t = JT.make_transport(*init.shape)
    t.pool = jnp.asarray(init)
    return t


def test_ranks_agree_on_every_result(four):
    """SPMD: every rank gathers the same pools and reads the same words."""
    for r in four[1:]:
        for key in ("ici_pool", "static_ici_pool", "neg_zero_ici",
                    "fault_pool", "fault_clean_pool"):
            assert np.array_equal(_words(r[key]), _words(four[0][key])), key
        assert r["fanin"] == four[0]["fanin"]


def test_same_shape_fresh_addresses_one_new_descriptor_key(four):
    """20 address-varying batches of one shape: one bucket key in the
    process (``descriptor_cache_size``) and the reference's ledger."""
    r = four[0]
    assert r["descriptor_keys"] == [1] * 20
    rng = np.random.default_rng(0)
    t = _jax_local(rng.standard_normal((2, 256)).astype(np.float32))
    for _ in range(20):
        sa, da = int(rng.integers(0, 96)), int(rng.integers(128, 224))
        t.execute_batch([("xfer", 0, 1, sa, da, 30)])
    assert r["local_stats"] == {k: t.stats[k] for k in r["local_stats"]}


def test_ici_transport_parity_and_cache(four):
    """The twin on 4 ranks equals LocalTransport (the port's and the JAX
    package's) byte for byte; 10 dispatches in at most 3 buckets."""
    r = four[0]
    assert r["ici_type"] == "ICITransport" and r["ici_row_shape"] == (1, 64)
    assert r["small_type"] == "LocalTransport"   # n_peers != world size
    assert np.array_equal(_words(r["ici_pool"]), _words(r["local_pool"]))
    init = np.random.default_rng(0).standard_normal((4, 64)).astype(
        np.float32)
    jt = _jax_local(init)
    for plan in r["plans"]:
        jt.execute_batch(plan)
    assert np.array_equal(_words(r["ici_pool"]), _words(np.asarray(jt.pool)))
    assert r["ici_stats"]["dispatches"] == 10
    assert r["ici_stats"]["compiles"] <= 3


def test_seed_executors_match_the_reference(four):
    """execute_batch_static and host_write_static on both transports
    equal the JAX package's seed executors, overrunning addresses and an
    out-of-range peer included (clamp-and-shift, nothing dropped)."""
    r = four[0]
    init = np.random.default_rng(0).standard_normal((4, 64)).astype(
        np.float32)
    jt = _jax_local(init)
    for plan in r["plans"] + [R.OVERRUN_PLAN]:
        jt.execute_batch_static(plan)
    h0 = JT.host_write_cache_size()
    for peer, addr, ln in ((1, 60, 8), (7, -5, 3), (2, 3, 8)):
        jt.host_write_static(peer, addr, np.arange(ln, dtype=np.float32)
                             + 100 * peer)
    want = _words(np.asarray(jt.pool))
    assert np.array_equal(_words(r["static_ici_pool"]), want)
    assert np.array_equal(_words(r["static_local_pool"]), want)
    # two lengths, two seed host-write keys (the reference's jit cache
    # may hold them from another test already)
    assert r["static_host_keys"] == 2
    assert JT.host_write_cache_size() - h0 <= 2


def test_descriptor_executor_differs_from_the_seed_at_an_overrun(four):
    """At overrunning addresses the descriptor executor clips its source
    lanes and drops (or wraps) its destination lanes where the seed
    executor shifts the whole copy: the two pools differ, and each
    equals its reference counterpart."""
    init = np.random.default_rng(0).standard_normal((4, 64)).astype(
        np.float32)
    jd, js = _jax_local(init), _jax_local(init)
    jd.execute_batch(R.OVERRUN_PLAN)
    js.execute_batch_static(R.OVERRUN_PLAN)
    desc = four[0]["overrun_descriptor_pool"]
    assert np.array_equal(_words(desc), _words(np.asarray(jd.pool)))
    assert not np.array_equal(_words(desc), _words(np.asarray(js.pool)))


def test_twin_keeps_negative_zero_bytes(four):
    """A 9-word transfer of eight -0.0 and one 1.5 lands byte for byte on
    the twin, across rows and within one, as on LocalTransport."""
    r = four[0]
    assert np.array_equal(_words(r["neg_zero_ici"]),
                          _words(r["neg_zero_local"]))
    assert np.signbit(r["neg_zero_ici"][1, 16:24]).all()
    assert np.signbit(r["neg_zero_ici"][2, 32:40]).all()
    assert r["neg_zero_ici"][1, 24] == r["neg_zero_ici"][2, 40] == 1.5


def test_reference_ici_flattens_negative_zero_where_the_twin_keeps_it(
        four, tmp_path):
    """The reference's ICITransport broadcasts a chunk by a masked
    ``psum``, so every landed -0.0 comes out +0.0, even within one row
    (a reference fault; ROADMAP Queue 3). Run in a forced 4-device
    subprocess, as the reference's own ICI tests run."""
    out = tmp_path / "pool.npy"
    code = f"""
import numpy as np
import jax.numpy as jnp
from repro.core.rdma.transport import ICITransport, make_transport
init = np.ones((4, 64), np.float32)
init[:, :8] = -0.0
init[:, 8] = 1.5
t = make_transport(4, 64)
assert isinstance(t, ICITransport), type(t)
t.pool = jnp.asarray(init)
t.execute_batch({R.NEG_ZERO_PLAN!r})
np.save({str(out)!r}, np.asarray(t.pool))
print("REF_ICI_OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert "REF_ICI_OK" in r.stdout, r.stdout + r.stderr
    ref = np.load(out)
    assert not np.signbit(ref[1, 16:24]).any()
    assert not np.signbit(ref[2, 32:40]).any()
    twin = four[0]["neg_zero_ici"]
    # only the landed -0.0 words differ
    diff = _words(ref) != _words(twin)
    assert diff.sum() == 16 and diff[1, 16:24].all() and diff[2, 32:40].all()


def test_ici_staged_host_write_round_trip(four):
    r = four[0]
    assert r["qdma_reads"] == [True] * 7
    assert r["qdma_stats"]["qdma_compiles"] <= 2
    assert r["qdma_stats"]["qdma_writes"] == 7
    assert r["staging_keys"] <= 2


def test_ici_overrunning_host_write_raises_on_every_rank(four):
    for r in four:
        assert len(r["oob_errors"]) == 2
        assert all("out of bounds" in e for e in r["oob_errors"])
        assert r["oob_qdma_writes"] == 7       # nothing was accounted


def test_ici_transport_parity_under_faults(four):
    """10% seeded drop + dup + corrupt on 4 ranks: byte parity with the
    fault-free run and with the JAX package's fault-free engine, zero
    outstanding retransmits at the end."""
    r = four[0]
    assert r["fault_type"] == "ICITransport"
    assert np.array_equal(_words(r["fault_pool"]),
                          _words(r["fault_clean_pool"]))
    jeng = R.fault_run(J.RDMAEngine(n_peers=4, pool_size=1024),
                       J.WQE, J.Opcode)
    assert np.array_equal(_words(r["fault_pool"]),
                          _words(np.asarray(jeng.transport.pool)))
    rel = r["fault_rel"]
    assert rel["retransmits"] > 0 and rel["retx_pressure"] == 0


def test_ici_transport_real_collectives(four):
    """Batched READs across peers into peer 0 (4 peers, one each)."""
    assert four[0]["fanin"] == [2.0, 3.0, 4.0]


def test_allreduce_parity_ici_transport(four):
    r = four[0]
    assert r["allreduce_type"] == "ICITransport"
    for got in r["allreduce"]:
        assert np.array_equal(got, r["allreduce_want"])


def test_offload_parity_on_ici_transport(two):
    """K5 and K3 (plain versions) through the Lookaside block on 2 ranks:
    byte-equal to the single-process run, the parser to its oracle, the
    matmul within the port's matmul tolerance of its oracle."""
    import repro_torch.core.rdma as T
    from repro_torch.core.lookaside import ControlMsg, LookasideBlock
    from repro_torch.kernels import lc_offload as lco
    local = R.lookaside_traffic(
        T.RDMAEngine(n_peers=2, pool_size=1 << 14, device="cpu"),
        ControlMsg, LookasideBlock, lco)
    for r in two:
        assert r["type"] == "ICITransport"
        assert r["mm_ok"] and r["parse_ok"]
        for key in ("mm", "parsed", "pool"):
            assert np.array_equal(_words(r[key]), _words(local[key])), key
        assert r["lc_wqes"] == local["lc_wqes"]
    r = two[0]
    want = np.asarray(jref.ref_matmul(jnp.asarray(r["A"]),
                                      jnp.asarray(r["B"])))
    np.testing.assert_allclose(r["mm"], want, rtol=0, atol=1e-5 * 16 / 128)
    np.testing.assert_array_equal(
        r["parsed"], np.asarray(jref.ref_parse_packets(
            jnp.asarray(r["pkts"]))))
