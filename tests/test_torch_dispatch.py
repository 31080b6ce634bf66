"""The port's match→action dispatch plane and K4 against the JAX package.

Mirrors ``test_dispatch.py``: table semantics, the structured Action API
and its deprecation shim, the full-field classifier, mixed-class
dispatch, and wrap × multi-class accounting. Each scenario runs on
``repro`` (Pallas kernels in interpret mode) and on ``repro_torch`` with
``device="cpu"`` from the same seeded headers; both must agree byte for
byte — pools, CQEs, ``engine.stats`` (``dispatch``, ``lc_pipeline``,
``rx_ring_*``), ring and router counters — and the reference's own
assertions then hold on the port's values.

K4 ``parse_packet_fields``: the port's plain version (what its wrapper
runs for a CPU tensor) is byte-exact against the Pallas kernel in
interpret mode on random bytes, crafted RoCE and non-RoCE headers and
packet counts that are no multiple of 256. The CUDA kernel is held
against the plain version on the card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sides import (SIDES, TORCH, action_key, ring_stats,
                          router_counters, run_both, snapshot)
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.packet_parser import parse_packet_fields as j_fields
from repro_torch.kernels import ops as tops
from repro_torch.kernels.packet_parser import (FIELD_NAMES, N_FIELDS,
                                               parse_packet_fields,
                                               parse_packet_fields_plain)

POOL = 1 << 15
DATA_PEER, LC_PEER = 1, 0
CTRL_PORT, BULK_PORT = 9000, 9100
META_BASE, QUANT_BASE = 0, 2048
F = {name: i for i, name in enumerate(FIELD_NAMES)}


def _ctrl_header(s, i=0):
    return s.S.make_roce_header(i % 18, i, is_rdma=False, dport=CTRL_PORT)


def _bulk_header(s, rng, seed=0):
    h = s.S.make_roce_header(seed % 18, seed, is_rdma=False,
                             dport=BULK_PORT)
    h[50:] = rng.integers(0, 256, 14).astype(np.uint8)
    return h


def _mixed_headers(s, n, seed=5):
    """Interleaved rdma / ctrl / bulk stream (3 classes)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 3
        out.append(s.S.make_roce_header(4, i) if kind == 0
                   else _ctrl_header(s, i) if kind == 1
                   else _bulk_header(s, rng))
    return np.stack(out)


def _table(s):
    return (s.S.MatchTable(default=s.S.Drop())
            .add(s.S.Forward(), priority=10, is_rdma=1)
            .add(s.S.Handler(s.K.STREAM_PARSER_WORKLOAD), udp_dport=CTRL_PORT)
            .add(s.S.Handler(s.K.STREAM_QUANT_WORKLOAD),
                 udp_dport=BULK_PORT))


def _dispatch_setup(s, depth=16, burst=8, pipeline_depth=4, policy="drop"):
    eng = s.RDMAEngine(n_peers=2, pool_size=POOL)
    blk = s.lk.LookasideBlock(eng, peer=LC_PEER, scratch_base=POOL // 2,
                              scratch_size=POOL // 4,
                              pipeline_depth=pipeline_depth,
                              eager_writeback=(pipeline_depth == 1))
    s.K.register_default_kernels(blk)
    ring = s.S.RXRing(eng, peer=LC_PEER, base=POOL - depth * 64,
                      depth=depth, policy=policy)
    meta_mr = eng.register_mr(DATA_PEER, META_BASE, depth * 4)
    quant_mr = eng.register_mr(DATA_PEER, QUANT_BASE,
                               depth * s.K.QUANT_ROW)
    disp = s.S.StreamDispatcher(blk, ring, _table(s), burst=burst)
    disp.register_handler(s.K.STREAM_PARSER_WORKLOAD, DATA_PEER,
                          meta_mr.rkey, META_BASE)
    disp.register_handler(s.K.STREAM_QUANT_WORKLOAD, DATA_PEER,
                          quant_mr.rkey, QUANT_BASE)
    router = s.TrafficRouter(rx_ring=ring, table=disp.table)
    return eng, blk, ring, disp, router


def _rows(eng, depth, seqs, base, width):
    rows = eng.read_buffer(DATA_PEER, base, depth * width
                           ).reshape(depth, width)
    return np.stack([rows[s % depth] for s in seqs])


def _want_quant(hdrs):
    q, s = ref.ref_quantize(jnp.asarray(np.asarray(hdrs, np.float32)))
    return np.concatenate([np.asarray(q, np.float32),
                           np.asarray(s, np.float32)], axis=1)


def _observe(eng, ring, router=None, **extra):
    out = dict(snapshot(eng), ring=ring_stats(ring), space=ring.space,
               **extra)
    if router is not None:
        out["router"] = router_counters(router)
    return out


def _vec(**fields):
    vec = np.zeros(N_FIELDS, np.int64)
    for name, v in fields.items():
        vec[F[name]] = v
    return vec


class TestMatchTable:
    def test_priority_and_tie_break(self):
        def scenario(s):
            t = (s.S.MatchTable(default=s.S.Drop())
                 .add(s.S.Handler(1), priority=1, udp_dport=80)
                 .add(s.S.Handler(2), priority=9, udp_dport=80)
                 .add(s.S.Handler(3), priority=9, udp_dport=80))
            return [action_key(t.match(_vec(udp_dport=p))) for p in (80, 81)]

        assert run_both(scenario) == [("Handler", (3, False)),
                                      ("Drop", ())]

    def test_ranges_inclusive_and_wildcards(self):
        def scenario(s):
            t = s.S.MatchTable(default=s.S.Drop()).add(s.S.Handler(7),
                                                       opcode=(6, 11))
            return [action_key(t.match(_vec(opcode=op)))
                    for op in (5, 6, 11, 12)]

        h7 = ("Handler", (7, False))
        assert run_both(scenario) == [("Drop", ()), h7, h7, ("Drop", ())]

    def test_multi_field_entries_are_conjunctions(self):
        def scenario(s):
            t = s.S.MatchTable(default=s.S.Drop()).add(
                s.S.Forward(), is_rdma=1, opcode=(12, 12))
            return [action_key(t.match(_vec(is_rdma=1, opcode=op)))
                    for op in (12, 13)]

        assert run_both(scenario) == [("Forward", (False,)), ("Drop", ())]

    @pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
    def test_unknown_field_and_empty_range_raise(self, side):
        with pytest.raises(KeyError, match="unknown match field"):
            side.S.MatchTable().add(side.S.Forward(), not_a_field=3)
        with pytest.raises(ValueError, match="empty range"):
            side.S.MatchTable().add(side.S.Forward(), opcode=(5, 2))

    def test_classify_agrees_with_match(self):
        def scenario(s):
            t = _table(s)
            fields = s.classify_headers(_mixed_headers(s, 12))
            acts = t.classify(fields)
            assert acts == [t.match(v) for v in fields]
            return {"fields": fields, "acts": [action_key(a) for a in acts]}

        got = run_both(scenario)["acts"]
        assert got[::3] == [("Forward", (False,))] * 4
        assert got[1::3] == [("Handler", (TORCH.K.STREAM_PARSER_WORKLOAD,
                                          False))] * 4
        assert got[2::3] == [("Handler", (TORCH.K.STREAM_QUANT_WORKLOAD,
                                          False))] * 4

    def test_handler_ids_and_chain_actions(self):
        def scenario(s):
            t = _table(s).add(s.S.Chain((0x20, 0x21), name="c"),
                              udp_dport=7)
            return t.handler_ids, [action_key(c) for c in t.chain_actions]

        wids, chains = run_both(scenario)
        assert wids == [TORCH.K.STREAM_PARSER_WORKLOAD,
                        TORCH.K.STREAM_QUANT_WORKLOAD]
        assert chains == [("Chain", ((0x20, 0x21), "c", False))]


class TestActionAPI:
    def test_shed_folds_into_the_action(self):
        def scenario(s):
            t = (s.S.MatchTable(default=s.S.Stream())
                 .add(s.S.Forward(), is_rdma=1)
                 .add(s.S.Stream(shed=True), udp_dport=80))
            t2 = s.S.MatchTable().add(s.S.Handler(5), shed=True,
                                      udp_dport=80)
            return (t.match(_vec(udp_dport=80)).shed,
                    t.match(_vec(udp_dport=81)).shed,
                    action_key(t2.entries[0].action),
                    action_key(s.S.as_action(s.S.Drop(), shed=True)))

        assert run_both(scenario) == (True, False, ("Handler", (5, True)),
                                      ("Drop", ()))

    def test_chain_tag_deterministic_and_disjoint(self):
        def scenario(s):
            c = s.S.Chain((0x22, 0x23), name="egress")
            with pytest.raises(ValueError):
                s.S.Chain(())
            return (c.tag, s.S.Chain((0x22, 0x23)).tag,
                    s.S.Chain((0x23, 0x22)).tag, c.stages)

        tag, same, swapped, stages = run_both(scenario)
        assert tag == same != swapped
        assert tag >> 24 == 0x43 and stages == (0x22, 0x23)

    def test_legacy_int_and_sentinel_actions_classify_identically(self):
        def scenario(s):
            with pytest.warns(DeprecationWarning) as rec:
                legacy = (s.S.MatchTable(default="drop")
                          .add("rdma", priority=10, is_rdma=1)
                          .add(s.K.STREAM_PARSER_WORKLOAD,
                               udp_dport=CTRL_PORT)
                          .add(s.K.STREAM_QUANT_WORKLOAD,
                               udp_dport=BULK_PORT))
            fields = s.classify_headers(_mixed_headers(s, 12))
            assert legacy.classify(fields) == _table(s).classify(fields)
            assert legacy.handler_ids == _table(s).handler_ids
            return len(rec), [action_key(a) for a in legacy.classify(fields)]

        n_warn, _ = run_both(scenario)
        assert n_warn == 3 + 1                   # 3 adds + default

    @pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
    def test_shim_rejects_unknown_actions(self, side):
        with pytest.raises(TypeError, match="unsupported table action"):
            side.S.as_action("tie")
        with pytest.raises(TypeError):
            side.S.as_action(True)
        assert side.S.as_action(side.S.Forward()) == side.S.Forward()


def _k4_headers(n, seed):
    """Random bytes, with crafted RoCEv2 headers on every other packet
    (opcodes across every class and the whole byte range) and non-RoCE
    UDP/IPv4 headers on every fourth."""
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, size=(n, 64)).astype(np.uint8)
    pkts[::2, 12:14] = [0x08, 0x00]
    pkts[::2, 23] = 17
    pkts[::2, 36:38] = [18, 183]
    pkts[::2, 42] = rng.integers(0, 256, size=pkts[::2].shape[0])
    pkts[1::4, 12:14] = [0x08, 0x00]
    pkts[1::4, 23] = 17
    pkts[1::4, 36:38] = [0x23, 0x28]                # dport 9000
    return pkts


class TestFullFieldClassifier:
    @pytest.mark.parametrize("n", [256, 512])
    def test_k4_plain_byte_exact_vs_pallas(self, n):
        pkts = _k4_headers(n, n)
        want = np.asarray(j_fields(jnp.asarray(pkts), interpret=True))
        got = parse_packet_fields(torch.from_numpy(pkts))
        assert got.dtype == torch.int32 and got.shape == (n, N_FIELDS)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            parse_packet_fields_plain(torch.from_numpy(pkts)).numpy(), want)

    @pytest.mark.parametrize("n", [1, 13, 255, 300])
    def test_k4_any_n_matches_padded_reference(self, n):
        """The port takes any n; the reference pads to its block."""
        pkts = _k4_headers(n, 7 + n)
        want = np.asarray(jops.classify_packet_fields(jnp.asarray(pkts)))
        np.testing.assert_array_equal(
            tops.classify_packet_fields(torch.from_numpy(pkts)).numpy(),
            want)
        np.testing.assert_array_equal(
            np.asarray(j_fields(jnp.asarray(pkts), block_p=n,
                                interpret=True)), want)

    def test_k4_crafted_headers_every_opcode(self):
        """One RoCEv2 header per opcode 0..255 plus non-RoCE twins."""
        hdrs = [TORCH.S.make_roce_header(op, (op * 7919) & 0xFFFFFF)
                for op in range(256)]
        hdrs += [TORCH.S.make_roce_header(op, op, is_rdma=False,
                                          dport=4791 + op % 3 - 1)
                 for op in range(0, 256, 5)]
        pkts = np.stack(hdrs)
        want = np.asarray(j_fields(jnp.asarray(
            np.concatenate([pkts, np.zeros((512 - len(pkts), 64),
                                           np.uint8)])),
            interpret=True))[:len(pkts)]
        got = parse_packet_fields(torch.from_numpy(pkts)).numpy()
        np.testing.assert_array_equal(got, want)
        # every class occurs, and raw opcode/dest_qp survive off RDMA
        assert set(got[:256, F["cls"]]) == set(range(1, 7))
        off = got[256:][got[256:, F["is_rdma"]] == 0]
        assert off[:, F["opcode"]].any() and off[:, F["cls"]].max() == 0

    def test_k4_launch_counter_and_device_rules(self):
        before = parse_packet_fields.launches
        parse_packet_fields(torch.zeros((3, 64), dtype=torch.uint8))
        assert parse_packet_fields.launches == before   # CPU: plain
        with pytest.raises(ValueError, match="CUDA"):
            parse_packet_fields(torch.empty((2, 64), dtype=torch.uint8,
                                            device="meta"))
        with pytest.raises(TypeError):
            parse_packet_fields(torch.zeros((2, 64), dtype=torch.int32))
        with pytest.raises(ValueError):
            parse_packet_fields(torch.zeros((2, 63), dtype=torch.uint8))

    def test_fields_match_oracle_and_meta_view(self):
        def scenario(s):
            hdrs = _mixed_headers(s, 9)
            return {"hdrs": hdrs, "fields": s.classify_headers(hdrs)}

        got = run_both(scenario)
        fields, hdrs = got["fields"], got["hdrs"]
        assert fields.dtype == np.int32
        want = np.asarray(ref.ref_parse_fields(jnp.asarray(hdrs)))
        np.testing.assert_array_equal(fields, want)
        meta = np.asarray(ref.ref_parse_packets(jnp.asarray(hdrs)))
        np.testing.assert_array_equal(meta[:, 0], fields[:, 0])
        np.testing.assert_array_equal(meta[:, 1],
                                      fields[:, 1] * fields[:, 0])
        np.testing.assert_array_equal(meta[:, 3], fields[:, 3])

    def test_non_rdma_ports_stay_separable(self):
        def scenario(s):
            return s.classify_headers(np.stack([
                _ctrl_header(s), _bulk_header(s, np.random.default_rng(1))]))

        fields = run_both(scenario)
        assert fields[0, F["udp_dport"]] == CTRL_PORT
        assert fields[1, F["udp_dport"]] == BULK_PORT
        assert not fields[:, F["is_rdma"]].any()


class TestDispatchParity:
    @pytest.mark.parametrize("pipeline_depth", [1, 4])
    def test_mixed_stream_byte_identical_to_oracles(self, pipeline_depth):
        def scenario(s):
            hdrs = _mixed_headers(s, 24)
            eng, _, ring, disp, router = _dispatch_setup(
                s, depth=16, burst=4, pipeline_depth=pipeline_depth)
            counts = router.ingest_packets(hdrs)
            n = disp.service()
            return _observe(eng, ring, router, hdrs=hdrs, counts=counts,
                            n=n,
                            meta=_rows(eng, 16, range(0, 16, 2),
                                       META_BASE, 4),
                            quant=_rows(eng, 16, range(1, 16, 2),
                                        QUANT_BASE, TORCH.K.QUANT_ROW))

        got = run_both(scenario)
        assert got["counts"] == {"rdma": 8, "streamed": 16, "dropped": 0,
                                 "backpressure": 0, "shed": 0}
        assert got["n"] == 16
        np.testing.assert_array_equal(got["meta"], np.asarray(
            ref.ref_parse_packets(jnp.asarray(got["hdrs"][1::3]))))
        np.testing.assert_array_equal(got["quant"],
                                      _want_quant(got["hdrs"][2::3]))
        assert got["space"] == 16

    def test_handlers_share_flush_and_stats_ledger(self):
        def scenario(s):
            eng, _, ring, disp, router = _dispatch_setup(s, depth=16,
                                                         burst=8)
            router.ingest_packets(_mixed_headers(s, 24))
            f0 = eng.stats["flushes"]
            n = disp.service()
            return _observe(eng, ring, router, n=n,
                            flushes=eng.stats["flushes"] - f0)

        got = run_both(scenario)
        assert got["n"] == 16 and got["flushes"] == 2
        dp = got["stats"]["dispatch"]
        assert dp["dispatch_rounds"] == 1
        assert dp["dispatch_mixed_rounds"] == 1
        assert dp["classes"]["packet_parser_stream"]["pkts"] == 8
        assert dp["classes"]["quantize_stream"]["pkts"] == 8
        assert got["stats"]["transport"]["interleaved_batches"] >= 1
        lp = got["stats"]["lc_pipeline"]
        assert lp["head"] == lp["tail"] == 2

    def test_multi_round_mixed_stream_overlaps_fetch_with_writeback(self):
        def scenario(s):
            eng, _, ring, disp, router = _dispatch_setup(s, depth=32,
                                                         burst=8)
            router.ingest_packets(_mixed_headers(s, 48))
            f0 = eng.stats["flushes"]
            n = disp.service()
            return _observe(eng, ring, router, n=n,
                            flushes=eng.stats["flushes"] - f0)

        got = run_both(scenario)
        assert got["n"] == 32 and got["flushes"] == 3
        lp = got["stats"]["lc_pipeline"]
        assert lp["overlapped_flushes"] >= 1
        assert lp["fetch_wqes_overlapped"] > 0
        assert got["stats"]["dispatch"]["dispatch_mixed_rounds"] == 2

    def test_table_drop_action_never_wedges_the_ring(self):
        def scenario(s):
            eng, blk, ring, disp, router = _dispatch_setup(s, depth=8,
                                                           burst=4)
            stray = s.S.make_roce_header(0, 0, is_rdma=False, dport=7777)
            ok = (ring.push(stray, cls=0x77),
                  ring.push(_ctrl_header(s, 0),
                            cls=s.K.STREAM_PARSER_WORKLOAD))
            return _observe(eng, ring, ok=ok, n=disp.service())

        got = run_both(scenario)
        assert got["ok"] == (True, True) and got["n"] == 1
        assert got["stats"]["dispatch"]["dispatch_dropped_pkts"] == 1
        assert got["space"] == 8
        assert got["ring"]["consumed"] == 1 and got["ring"]["swept"] == 1
        t = got["stats"]["transport"]
        assert t["rx_ring_swept"] == 1 and t["rx_ring_consumed"] == 1

    def test_unregistered_handler_default_still_sweeps_orphans(self):
        def scenario(s):
            eng, blk, ring, _, _ = _dispatch_setup(s, depth=4, burst=4)
            disp = s.S.StreamDispatcher(
                blk, ring, s.S.MatchTable(default=s.S.Handler(0x99)),
                burst=4)
            mr = eng.register_mr(DATA_PEER, 0, 16)
            disp.register_handler(s.K.STREAM_PARSER_WORKLOAD, DATA_PEER,
                                  mr.rkey, 0)
            ok = [ring.push(_ctrl_header(s, i)) for i in range(4)]
            n = disp.service()
            space = ring.space
            return _observe(eng, ring, ok=ok, n=n, freed=space,
                            again=ring.push(_ctrl_header(s, 9)))

        got = run_both(scenario)
        assert all(got["ok"]) and got["n"] == 0
        assert got["freed"] == 4 and got["again"] is True
        assert got["stats"]["dispatch"]["dispatch_dropped_pkts"] == 4
        assert got["ring"]["swept"] == 4 and got["ring"]["consumed"] == 0

    def test_no_new_shape_buckets_after_mixed_warmup(self):
        """The port's analogue of the reference's zero steady-state
        compiles: the shape-bucket misses stop growing after one warm-up
        cycle, with the same counts as the reference."""
        def scenario(s):
            hdrs = _mixed_headers(s, 48)
            eng, _, ring, disp, router = _dispatch_setup(s, depth=16,
                                                         burst=4)
            t = eng.stats["transport"]

            def cycle():
                i = 0
                while i < len(hdrs):
                    n = min(24, len(hdrs) - i)
                    counts = router.ingest_packets(hdrs[i:i + n])
                    assert disp.service() == counts["streamed"]
                    i += n

            cycle()
            warm = (t["cache_misses"], t["qdma_cache_misses"])
            cycle()
            return _observe(eng, ring, router, warm=warm, steady=(
                t["cache_misses"], t["qdma_cache_misses"]))

        got = run_both(scenario)
        assert got["warm"] == got["steady"]


class TestWrapMultiClass:
    def test_wrap_straddling_subbursts_keep_per_handler_fifo(self):
        def scenario(s):
            rng = np.random.default_rng(3)
            eng, _, ring, disp, router = _dispatch_setup(s, depth=8,
                                                         burst=8)
            first = np.stack([_ctrl_header(s, i) if i % 2 == 0
                              else _bulk_header(s, rng) for i in range(8)])
            router.ingest_packets(first)
            n1 = disp.service()
            later = np.stack([_ctrl_header(s, 10 + i) if i % 2 == 0
                              else _bulk_header(s, rng) for i in range(6)])
            router.ingest_packets(later)
            w0 = ring.stats["wrap_bursts"]
            n2 = disp.service()
            w1 = ring.stats["wrap_bursts"]
            more = np.stack([_bulk_header(s, rng), _ctrl_header(s, 20),
                             _ctrl_header(s, 21), _bulk_header(s, rng)])
            router.ingest_packets(more)
            n3 = disp.service()
            return _observe(
                eng, ring, router, n=(n1, n2, n3), wraps=(w0, w1),
                later=later, more=more,
                ctrl=_rows(eng, 8, [10, 12, 15, 16], META_BASE, 4),
                bulk=_rows(eng, 8, [11, 13, 14, 17], QUANT_BASE,
                           TORCH.K.QUANT_ROW))

        got = run_both(scenario)
        assert got["n"] == (8, 6, 4)
        w0, w1 = got["wraps"]
        assert w1 == w0 and got["ring"]["wrap_bursts"] == w0 + 1
        later, more = got["later"], got["more"]
        np.testing.assert_array_equal(got["ctrl"], np.asarray(
            ref.ref_parse_packets(jnp.asarray(np.stack(
                [later[2], later[4], more[1], more[2]])))))
        np.testing.assert_array_equal(got["bulk"], _want_quant(np.stack(
            [later[3], later[5], more[0], more[3]])))

    @pytest.mark.parametrize("policy,key", [("drop", "dropped"),
                                            ("backpressure",
                                             "backpressure")])
    def test_router_and_ring_accounting_agree_on_refusals(self, policy,
                                                          key):
        def scenario(s):
            rng = np.random.default_rng(4)
            eng, _, ring, disp, router = _dispatch_setup(
                s, depth=4, burst=4, policy=policy)
            hdrs = np.stack([_ctrl_header(s, i) if i % 2 == 0
                             else _bulk_header(s, rng) for i in range(7)])
            counts = router.ingest_packets(hdrs)
            n = disp.service()
            retry = (router.ingest_packets(hdrs[4:])
                     if policy == "backpressure" else None)
            return _observe(eng, ring, router, counts=counts, n=n,
                            retry=retry)

        got = run_both(scenario)
        assert got["counts"]["streamed"] == 4 and got["counts"][key] == 3
        t = got["stats"]["transport"]
        assert got["ring"]["consumed"] == t["rx_ring_consumed"] == 4
        assert got["n"] == 4
        if policy == "backpressure":
            assert got["retry"]["streamed"] == 3
        else:
            assert got["router"]["pkt"][key] == got["ring"][key] == 3
            assert t["rx_ring_" + key] == 3
            assert got["router"]["pkt"]["streamed"] == t["rx_ring_pushed"]
