"""The port's streaming RX ring and ingress against the JAX package's.

Mirrors ``test_streaming_rx.py``: every scenario runs on ``repro`` (its
Pallas kernels in interpret mode) and on ``repro_torch`` with
``device="cpu"`` from the same seeded headers, and both must agree byte
for byte — pools, every QP's CQEs, ``engine.stats`` (the ``rx_ring_*``
mirrors, ``lc_pipeline`` and ``dispatch`` ledgers included), the ring's
own counters and the router's counters. The reference's own assertions
then hold on the port's values. Wall-clock latency histograms are
compared by their sample counts only. The ``ICITransport`` subprocess
case is not ported yet.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_sides import ring_stats, router_counters, run_both, snapshot
from repro.core.streaming import rx_ring as j_rx
from repro.kernels import ref
from repro_torch.core.streaming import rx_ring as t_rx

POOL = 1 << 15
DATA_PEER, LC_PEER = 1, 0


def _headers(n, seed):
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, size=(n, 64)).astype(np.uint8)
    pkts[::2, 12:14] = [8, 0]
    pkts[::2, 23] = 17
    pkts[::2, 36:38] = [18, 183]
    return pkts


def _want(pkts):
    return np.asarray(ref.ref_parse_packets(jnp.asarray(pkts)))


def _stream_setup(s, depth=16, burst=8, pipeline_depth=1, policy="drop"):
    eng = s.RDMAEngine(n_peers=2, pool_size=POOL)
    blk = s.lk.LookasideBlock(eng, peer=LC_PEER, scratch_base=POOL // 2,
                              scratch_size=POOL // 4,
                              pipeline_depth=pipeline_depth,
                              eager_writeback=(pipeline_depth == 1))
    s.K.register_default_kernels(blk)
    ring = s.S.RXRing(eng, peer=LC_PEER, base=POOL - depth * 64,
                      depth=depth, policy=policy)
    out_mr = eng.register_mr(DATA_PEER, 0, depth * 4)
    k = blk.attach_ring(s.K.STREAM_PARSER_WORKLOAD, ring,
                        out_peer=DATA_PEER, out_rkey=out_mr.rkey,
                        out_base=0, burst=burst)
    return eng, blk, ring, k


def _meta_rows(eng, ring, seqs):
    rows = eng.read_buffer(DATA_PEER, 0, ring.depth * 4
                           ).reshape(ring.depth, 4)
    return np.stack([rows[s % ring.depth] for s in seqs])


def _observe(eng, ring, **extra):
    return dict(snapshot(eng), ring=ring_stats(ring),
                occupancy=ring.occupancy, space=ring.space, **extra)


class TestRingMechanics:
    def test_slot_data_lands_in_pool(self):
        pkts = _headers(3, 1)

        def scenario(s):
            eng, _, ring, _ = _stream_setup(s, depth=4)
            ok = [ring.push(h) for h in pkts]
            slots = [eng.read_buffer(LC_PEER, ring.slot_addr(i), 64)
                     for i in range(3)]
            return _observe(eng, ring, ok=ok, slots=slots)

        got = run_both(scenario)
        assert got["ok"] == [True] * 3
        for slot, h in zip(got["slots"], pkts):
            np.testing.assert_array_equal(slot, h.astype(np.float32))
        assert got["occupancy"] == 3 and got["space"] == 1

    def test_full_ring_drop_policy_counts(self):
        pkts = _headers(5, 2)

        def scenario(s):
            eng, _, ring, _ = _stream_setup(s, depth=4, policy="drop")
            ok = [ring.push(h) for h in pkts]
            return _observe(eng, ring, ok=ok)

        got = run_both(scenario)
        assert got["ok"] == [True] * 4 + [False]
        t = got["stats"]["transport"]
        assert got["ring"]["dropped"] == 1
        assert t["rx_ring_dropped"] == 1 and t["rx_ring_pushed"] == 4
        assert t["rx_ring_peak_occupancy"] == 4

    def test_full_ring_backpressure_policy_counts(self):
        pkts = _headers(5, 3)

        def scenario(s):
            eng, _, ring, k = _stream_setup(s, depth=4,
                                            policy="backpressure")
            ok = [ring.push(h) for h in pkts]
            refused = dict(ring_stats(ring))
            streamed = k.stream()        # drain frees the ring
            retry = ring.push(pkts[4])   # the refused packet retries
            return _observe(eng, ring, ok=ok, refused=refused,
                            streamed=streamed, retry=retry)

        got = run_both(scenario)
        assert got["ok"] == [True] * 4 + [False]
        assert got["refused"]["backpressure"] == 1
        assert got["refused"]["dropped"] == 0
        assert got["stats"]["transport"]["rx_ring_backpressure"] == 1
        assert got["streamed"] == 4 and got["retry"] is True

    def test_claimed_slots_stay_allocated_until_gather_lands(self):
        pkts = _headers(6, 4)

        def scenario(s):
            _, _, ring, _ = _stream_setup(s, depth=4)
            for h in pkts[:4]:
                ring.push(h)
            spans, stamps = ring.begin_consume(3)
            held = (len(stamps), ring.available, ring.space,
                    ring.push(pkts[4]))
            ring.complete_consume(3)
            return {"spans": spans, "held": held, "space": ring.space,
                    "push": ring.push(pkts[5]), "ring": ring_stats(ring)}

        got = run_both(scenario)
        assert got["held"] == (3, 1, 0, False)
        assert got["space"] == 3 and got["push"] is True

    def test_wrap_around_splits_into_two_ordered_spans(self):
        pkts = _headers(12, 5)

        def scenario(s):
            _, _, ring, _ = _stream_setup(s, depth=8)
            for h in pkts[:8]:
                ring.push(h)
            ring.begin_consume(6)
            ring.complete_consume(6)     # head = 6
            ok = [ring.push(h) for h in pkts[8:]]    # seqs 8..11
            spans, _ = ring.begin_consume(6)         # seqs 6..11 wrap
            return {"ok": ok, "spans": spans, "wrap_addr": (
                ring.slot_addr(6), ring.base), "ring": ring_stats(ring)}

        got = run_both(scenario)
        assert got["ok"] == [True] * 4
        a6, base = got["wrap_addr"]
        assert got["spans"] == [(a6, 2), (base, 4)]
        assert got["ring"]["wrap_bursts"] == 1

    def test_latency_histogram_helpers_match(self):
        samples = [0.0, 3e-7, 1e-6, 1.5e-6, 7.9e-5, 2e-3, 2e-3]
        hists = []
        for rx in (j_rx, t_rx):
            h = {}
            for sec in samples:
                rx.record_latency_us(h, sec)
            hists.append((h, [rx.percentile_us(h, q)
                              for q in (0.0, 0.5, 0.99, 1.0)],
                          rx.percentile_us({})))
        assert hists[1] == hists[0]
        assert hists[1][0] == {1: 3, 2: 1, 128: 1, 2048: 2}


class TestStreamParity:
    @pytest.mark.parametrize("pipeline_depth", [1, 4])
    def test_stream_byte_identical_to_controlmsg_path(self,
                                                      pipeline_depth):
        pkts = _headers(14, 6)

        def controlmsg_meta(s):
            eng = s.RDMAEngine(n_peers=2, pool_size=POOL)
            blk = s.lk.LookasideBlock(eng, peer=LC_PEER,
                                      scratch_base=POOL // 2,
                                      scratch_size=POOL // 4)
            s.K.register_default_kernels(blk)
            n = len(pkts)
            mr = eng.register_mr(DATA_PEER, 0, n * 68)
            eng.write_buffer(DATA_PEER, 0, pkts.astype(np.float32).ravel())
            blk.dispatch(s.lk.ControlMsg(
                s.K.PARSER_WORKLOAD, (DATA_PEER, mr.rkey, 0, n, n * 64),
                tag=1))
            assert blk.poll(s.K.PARSER_WORKLOAD).ok
            return eng.read_buffer(DATA_PEER, n * 64, n * 4).reshape(n, 4)

        def scenario(s):
            eng, _, ring, k = _stream_setup(s, depth=16, burst=8,
                                            pipeline_depth=pipeline_depth)
            ok = [ring.push(h) for h in pkts]
            n = k.stream()               # bursts of 8 + 6
            return _observe(eng, ring, ok=ok, n=n,
                            meta=_meta_rows(eng, ring, range(14)),
                            ctrl=controlmsg_meta(s))

        got = run_both(scenario)
        assert all(got["ok"]) and got["n"] == 14
        np.testing.assert_array_equal(got["meta"], got["ctrl"])
        np.testing.assert_array_equal(got["meta"], _want(pkts))

    def test_wrap_burst_meta_rows_land_at_matching_slots(self):
        pkts = _headers(20, 7)

        def scenario(s):
            eng, _, ring, k = _stream_setup(s, depth=16, burst=6)
            for h in pkts[:16]:
                ring.push(h)
            first = k.stream(max_bursts=1)           # head = 6
            ok = [ring.push(h) for h in pkts[16:]]   # seq 16..19 wrap
            rest = k.stream()
            return _observe(eng, ring, n=(first, rest), ok=ok,
                            meta=_meta_rows(eng, ring, range(4, 20)))

        got = run_both(scenario)
        assert got["n"] == (6, 14) and all(got["ok"])
        assert got["ring"]["wrap_bursts"] == 1
        np.testing.assert_array_equal(got["meta"], _want(pkts)[4:])

    def test_no_new_shape_buckets_after_warmup(self):
        """The reference pins zero new XLA compiles at steady state; the
        port has no compile cache, so the same shape-bucket ledger
        (``cache_misses`` of the descriptor tables, ``qdma_cache_misses``
        of the staging writes) must stop growing after one warm-up
        cycle, with the same counts as the reference."""
        pkts = _headers(64, 8)

        def scenario(s):
            out = {}
            for depth in (1, 4):
                eng, _, ring, k = _stream_setup(s, depth=16, burst=8,
                                                pipeline_depth=depth)

                def cycle():
                    i = 0
                    while i < len(pkts):
                        n = min(16, len(pkts) - i)
                        for h in pkts[i:i + n]:
                            assert ring.push(h)
                        assert k.stream() == n
                        i += n

                t = eng.stats["transport"]
                cycle()                  # warm every shape bucket
                warm = (t["cache_misses"], t["qdma_cache_misses"])
                cycle()                  # steady state
                out[depth] = (warm, (t["cache_misses"],
                                     t["qdma_cache_misses"]),
                              snapshot(eng))
            return out

        got = run_both(scenario)
        for warm, steady, _ in got.values():
            assert warm == steady

    def test_pipelined_overlap_and_credit_conservation(self):
        pkts = _headers(48, 9)

        def scenario(s):
            out = []
            for depth in (1, 4):
                eng, _, ring, k = _stream_setup(s, depth=16, burst=6,
                                                pipeline_depth=depth)
                i = 0
                while i < len(pkts):
                    for h in pkts[i:i + 16]:
                        ring.push(h)
                    k.stream()
                    i += 16
                out.append(_observe(eng, ring, meta=_meta_rows(
                    eng, ring, range(32, 48))))
            return out

        serial, piped = run_both(scenario)
        np.testing.assert_array_equal(piped["meta"], serial["meta"])
        lp = piped["stats"]["lc_pipeline"]
        assert piped["stats"]["flushes"] < serial["stats"]["flushes"]
        assert lp["overlapped_flushes"] > 0
        assert lp["fetch_wqes_overlapped"] > 0
        assert lp["head"] == lp["tail"] == 9      # 3 bursts x 3 cycles
        assert 1 < lp["in_flight_peak"] <= lp["depth"]
        assert piped["ring"]["latency_us"] == piped["ring"]["consumed"] == 48

    def test_second_block_shares_engine_pipeline_ledger(self):
        pkts = _headers(8, 10)

        def scenario(s):
            eng, blk, ring, k = _stream_setup(s, depth=8, burst=4,
                                              pipeline_depth=4)
            for h in pkts:
                ring.push(h)
            n = k.stream()
            head0 = eng.stats["lc_pipeline"]["head"]
            blk2 = s.lk.LookasideBlock(eng, peer=LC_PEER, scratch_base=0,
                                       scratch_size=64, pipeline_depth=2)
            return {"n": n, "head0": head0,
                    "lp": dict(eng.stats["lc_pipeline"]),
                    "shared": blk2._lp is eng.stats["lc_pipeline"]}

        got = run_both(scenario)
        assert got["n"] == 8 and got["head0"] == 2
        assert got["lp"]["head"] == 2 and got["lp"]["depth"] == 4
        assert got["shared"] is True

    @pytest.mark.parametrize("depth", [1, 4])
    def test_generator_kernel_fault_surfaces_not_ok_status(self, depth):
        pkts = _headers(4, 11)

        def scenario(s):
            eng, blk, ring, k = _stream_setup(s, depth=8, burst=4,
                                              pipeline_depth=depth)
            k.stream_out = (DATA_PEER, 0xBAD, 0)     # corrupt out rkey
            for h in pkts:
                ring.push(h)
            n = k.stream()
            st = blk.poll(s.K.STREAM_PARSER_WORKLOAD)
            return _observe(eng, ring, n=n, ok=st.ok, detail=st.detail,
                            errors=blk.stats["errors"])

        got = run_both(scenario)
        assert got["n"] == 4 and got["ok"] is False
        assert got["errors"] == 1
        assert got["space"] == 8         # the failed burst freed its slots

    @pytest.mark.parametrize("depth", [1, 4])
    def test_fetch_phase_fault_still_frees_ring_slots(self, depth):
        pkts = _headers(8, 12)

        def scenario(s):
            eng, blk, ring, k = _stream_setup(s, depth=8, burst=8,
                                              pipeline_depth=depth)
            blk.scratch_size = 16        # ctx.alloc raises before a post
            blk._part_size = 16 // blk.pipeline_depth
            ok = [ring.push(h) for h in pkts]
            n = k.stream()
            st = blk.poll(s.K.STREAM_PARSER_WORKLOAD)
            space = ring.space
            return _observe(eng, ring, ok=ok, n=n, st_ok=st.ok,
                            detail=st.detail, freed=space,
                            again=ring.push(pkts[0]))

        got = run_both(scenario)
        assert all(got["ok"]) and got["n"] == 8
        assert got["st_ok"] is False and "scratch" in got["detail"]
        assert got["freed"] == 8 and got["again"] is True


class TestIngress:
    def test_router_lands_non_rdma_packets_in_ring(self):
        def scenario(s):
            eng, blk, ring, k = _stream_setup(s, depth=8, burst=8)
            router = s.TrafficRouter(rx_ring=ring)
            headers = np.stack([s.S.make_roce_header(4, 7,
                                                     is_rdma=(i % 2 == 0))
                                for i in range(8)])
            counts = router.ingest_packets(headers)
            occ = ring.occupancy
            n = k.stream()
            return _observe(eng, ring, headers=headers, counts=counts,
                            occ=occ, n=n, router=router_counters(router),
                            meta=_meta_rows(eng, ring, range(4)))

        got = run_both(scenario)
        assert got["counts"] == {"rdma": 4, "streamed": 4, "dropped": 0,
                                 "backpressure": 0, "shed": 0}
        assert got["router"]["pkt"]["streamed"] == 4
        assert got["occ"] == 4 and got["n"] == 4
        np.testing.assert_array_equal(got["meta"],
                                      _want(got["headers"][1::2]))
        assert not got["meta"][:, 0].any()

    @pytest.mark.parametrize("policy,key", [("drop", "dropped"),
                                            ("backpressure",
                                             "backpressure")])
    def test_ingest_ring_full_outcome_matches_ring_policy(self, policy,
                                                          key):
        def scenario(s):
            eng, _, ring, _ = _stream_setup(s, depth=2, policy=policy)
            router = s.TrafficRouter(rx_ring=ring)
            headers = np.stack([s.S.make_roce_header(0, 1, is_rdma=False)
                                for _ in range(4)])
            counts = router.ingest_packets(headers)
            return _observe(eng, ring, counts=counts,
                            router=router_counters(router))

        got = run_both(scenario)
        assert got["counts"]["streamed"] == 2 and got["counts"][key] == 2
        assert got["ring"][key] == 2
        assert got["router"]["pkt"][key] == 2

    def test_router_without_ring_drops_streamed_share(self):
        def scenario(s):
            router = s.TrafficRouter()
            counts = router.ingest_packets(
                np.stack([s.S.make_roce_header(0, 1, is_rdma=False)]))
            return {"counts": counts, "router": router_counters(router)}

        got = run_both(scenario)
        assert got["counts"] == {"rdma": 0, "streamed": 0, "dropped": 1,
                                 "backpressure": 0, "shed": 0}

    def test_shed_rows_drop_under_retransmit_pressure(self):
        """``shed=True`` rows are dropped at the MAC while the shedder
        sees pressure, in both packages, with the same ledgers."""
        def scenario(s):
            eng, _, ring, _ = _stream_setup(s, depth=8)
            shedder = s.rdma.LoadShedder(eng, threshold=1)
            shedder.should_shed = lambda: True       # pressure held high
            table = (s.S.MatchTable(default=s.S.Stream())
                     .add(s.S.Forward(), is_rdma=1)
                     .add(s.S.Stream(shed=True), udp_dport=80))
            router = s.TrafficRouter(rx_ring=ring, table=table,
                                     shedder=shedder)
            headers = np.stack([s.S.make_roce_header(0, i,
                                                     is_rdma=(i % 3 == 0),
                                                     dport=80 + i % 2)
                                for i in range(9)])
            counts = router.ingest_packets(headers)
            return _observe(eng, ring, counts=counts,
                            router=router_counters(router))

        got = run_both(scenario)
        assert got["counts"]["shed"] > 0
        assert got["stats"]["reliability"]["shed"] == got["counts"]["shed"]
