"""The port's service chains and gradient compression against the JAX
package's.

Mirrors ``test_chains.py`` and ``test_compress.py``. Each datapath
scenario runs on ``repro`` (Pallas kernels in interpret mode) and on
``repro_torch`` with ``device="cpu"``; both must agree byte for byte —
pools, CQEs, ``engine.stats`` (the per-chain ``dispatch`` ledger,
``lc_pipeline``, ``rx_ring_*``, the reliability ledger under faults),
stage output rows, checksums and the ``GradEgressChain`` q/s/residual —
and the reference's own assertions then hold on the port's values.

The pure compression functions get the same seeded numpy inputs on both
sides: q and s byte-exact, residuals byte-exact, and
``compressed_all_reduce`` (the JAX function run under ``jax.vmap`` with a
named axis, the port's over an explicit peer dimension) within the
reference's own bounds. The ``ICITransport`` subprocess case is not
ported yet.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sides import (JAX, SIDES, TORCH, ring_stats, run_both,
                          snapshot)
from repro.core.streaming import compress as jc
from repro.kernels.ref import ref_dequantize, ref_quantize
from repro_torch.core.streaming import compress as tc

POOL = 1 << 15
DATA_PEER, LC_PEER = 1, 0
DEPTH = 8


def _ingress_setup(s, eng=None, depth=DEPTH, burst=4, pipeline_depth=4):
    """Framed RX ring (129-word slots) + a parse→dequantize chain as the
    table DEFAULT, both stage rings slot-mirrored on the data peer."""
    eng = eng or s.RDMAEngine(n_peers=2, pool_size=POOL)
    blk = s.lk.LookasideBlock(eng, peer=LC_PEER, scratch_base=POOL // 2,
                              scratch_size=POOL // 4, eager_writeback=False,
                              pipeline_depth=pipeline_depth)
    s.K.register_chain_kernels(blk)
    ring = s.S.RXRing(eng, peer=LC_PEER, base=0, depth=depth,
                      slot_bytes=s.K.FRAME_ROW)
    chain = s.S.Chain((s.K.CHAIN_PARSE_WORKLOAD, s.K.CHAIN_DEQUANT_WORKLOAD),
                      name="ingress")
    disp = s.S.StreamDispatcher(blk, ring, s.S.MatchTable(default=chain),
                                burst=burst)
    s1 = s.K.FRAME_ROW * depth + 64
    s2 = s1 + s.K.PARSED_ROW * depth
    mr = eng.register_mr(DATA_PEER, s1,
                         (s.K.PARSED_ROW + s.K.HDR_BYTES) * depth)
    disp.register_chain(chain, DATA_PEER, mr.rkey, [s1, s2])
    return eng, blk, ring, disp, chain, (s1, s2)


def _frames(n, seed=0):
    """n framed ingress slots: 64 header bytes ‖ 65-word quant payload
    (64 int8 lanes as f32 + one fp32 scale)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        hdr = TORCH.S.make_roce_header(4, 100 + i, is_rdma=False,
                                       dport=9000)
        payload = np.concatenate([
            rng.integers(-127, 128, 64).astype(np.float32),
            np.asarray([rng.uniform(0.01, 2.0)], np.float32)])
        out.append(np.concatenate([hdr.astype(np.float32), payload]))
    return np.stack(out)


def _drive(ring, disp, frames, depth):
    """Push in ring-sized windows, one service pass per window."""
    pushed = 0
    for f in frames:
        if pushed == depth:
            disp.service()
            pushed = 0
        assert ring.push(f)              # untagged: the default chain owns it
        pushed += 1
    disp.service()


def _stage_rows(eng, base, row, depth, seqs):
    rows = eng.read_buffer(DATA_PEER, base, depth * row
                           ).reshape(depth, row)
    return np.stack([rows[s % depth] for s in seqs])


class TestChainStageComputes:
    def test_parse_and_dequant_stage_rows_byte_exact(self):
        frames = _frames(11, seed=3)
        for fn in ("parse_frame_rows", "dequant_trailing_rows"):
            rows = frames if fn == "parse_frame_rows" else \
                JAX.parse_frame_rows(frames)
            np.testing.assert_array_equal(getattr(TORCH, fn)(rows),
                                          getattr(JAX, fn)(rows))

    def test_compress_stage_rows_byte_exact(self):
        x = (np.random.default_rng(8).standard_normal((9, 64))
             * 10).astype(np.float32)
        x[4] = 0.0
        want = np.asarray(JAX.K._compress_rows(x, True))
        got = TORCH.K._compress_rows(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("w", [1, 2, 65, 129])
    def test_checksum_rows_byte_exact_with_nan_and_signed_zero(self, w):
        rng = np.random.default_rng(w)
        rows = (rng.standard_normal((7, w)) * 1e3).astype(np.float32)
        bits = rows.view(np.uint32)
        bits[0, 0] = 0x7FC00001          # NaN with a payload
        bits[1, -1] = 0xFFFFFFFF         # negative NaN, all bits set
        rows[2, 0] = -0.0
        rows[3, -1] = np.inf
        bits[4, :] = rng.integers(0, 2 ** 32, w, dtype=np.uint64).astype(
            np.uint32)
        want = JAX.checksum_rows(rows)
        got = TORCH.checksum_rows(rows)
        assert got.dtype == np.float32 and got.shape == (7, 2)
        np.testing.assert_array_equal(got, want)
        # (bits * w) mod 2^24 depends on bits mod 2^24 only: the stamp
        # sees every low mantissa bit but not the top 8 bits of a word —
        # the sign of zero included — in both packages alike
        flipped = rows.copy()
        flipped[2, 0] = 0.0
        np.testing.assert_array_equal(TORCH.checksum_rows(flipped), got)
        np.testing.assert_array_equal(JAX.checksum_rows(flipped), want)
        flipped.view(np.uint32)[5, 0] ^= 1
        assert TORCH.checksum_rows(flipped)[5, 0] != got[5, 0]


class TestChainRegistrationValidation:
    def _disp(self, s, slot_bytes=64, chain_kernels=True):
        eng = s.RDMAEngine(n_peers=2, pool_size=POOL)
        blk = s.lk.LookasideBlock(eng, peer=LC_PEER, scratch_base=POOL // 2,
                                  scratch_size=POOL // 4)
        if chain_kernels:
            s.K.register_chain_kernels(blk)
        else:
            s.K.register_default_kernels(blk)
        ring = s.S.RXRing(eng, peer=LC_PEER, base=0, depth=4,
                          slot_bytes=slot_bytes)
        mr = eng.register_mr(DATA_PEER, 0, 2048)
        return eng, s.S.StreamDispatcher(blk, ring, s.S.MatchTable()), mr

    @pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
    def test_unregistered_stage_rejected(self, side):
        _, disp, mr = self._disp(side)
        with pytest.raises(KeyError, match="not registered"):
            disp.register_chain(side.S.Chain((0x77,)), DATA_PEER, mr.rkey,
                                [0])

    @pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
    def test_non_chain_capable_stage_rejected(self, side):
        _, disp, mr = self._disp(side, chain_kernels=False)
        with pytest.raises(TypeError, match="not chain-capable"):
            disp.register_chain(
                side.S.Chain((side.K.STREAM_PARSER_WORKLOAD,)),
                DATA_PEER, mr.rkey, [0])

    @pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
    def test_row_widths_must_compose(self, side):
        K, Chain = side.K, side.S.Chain
        _, disp, mr = self._disp(side, slot_bytes=64)
        with pytest.raises(ValueError, match="in_row == 129"):
            disp.register_chain(Chain((K.CHAIN_PARSE_WORKLOAD,)),
                                DATA_PEER, mr.rkey, [0])
        _, disp, mr = self._disp(side, slot_bytes=32)
        with pytest.raises(ValueError, match="in_row >= 65"):
            disp.register_chain(Chain((K.CHAIN_DEQUANT_WORKLOAD,)),
                                DATA_PEER, mr.rkey, [0])
        _, disp, mr = self._disp(side, slot_bytes=64)
        disp.register_chain(
            Chain((K.CHAIN_COMPRESS_WORKLOAD, K.CHAIN_CHECKSUM_WORKLOAD)),
            DATA_PEER, mr.rkey, [0, 1024])
        with pytest.raises(ValueError, match="in_row == 129"):
            disp.register_chain(
                Chain((K.CHAIN_COMPRESS_WORKLOAD, K.CHAIN_PARSE_WORKLOAD)),
                DATA_PEER, mr.rkey, [0, 1024])

    @pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
    def test_stage_bases_arity_checked(self, side):
        K = side.K
        _, disp, mr = self._disp(side)
        with pytest.raises(ValueError, match="stage_bases"):
            disp.register_chain(
                side.S.Chain((K.CHAIN_COMPRESS_WORKLOAD,
                              K.CHAIN_CHECKSUM_WORKLOAD)),
                DATA_PEER, mr.rkey, [0])
        with pytest.raises(TypeError, match="expected a Chain"):
            disp.register_chain(side.S.Drop(), DATA_PEER, mr.rkey, [])


class TestIngressChainParity:
    def test_parse_dequant_byte_identical_to_composed_oracles(self):
        frames = _frames(13)
        live = list(range(5, 13))

        def scenario(s):
            eng, _, ring, disp, _, (s1, s2) = _ingress_setup(s)
            _drive(ring, disp, frames, DEPTH)
            return dict(snapshot(eng), ring=ring_stats(ring),
                        space=ring.space,
                        o1=_stage_rows(eng, s1, s.K.PARSED_ROW, DEPTH, live),
                        o2=_stage_rows(eng, s2, s.K.HDR_BYTES, DEPTH, live))

        got = run_both(scenario)
        o1 = TORCH.parse_frame_rows(frames)
        o2 = TORCH.dequant_trailing_rows(o1)
        np.testing.assert_array_equal(got["o1"], o1[live])
        np.testing.assert_array_equal(got["o2"], o2[live])
        assert got["space"] == DEPTH

    def test_per_chain_ledger_and_dataflow_accounting(self):
        def scenario(s):
            eng, _, ring, disp, _, _ = _ingress_setup(s)
            _drive(ring, disp, _frames(13), DEPTH)
            return dict(snapshot(eng), ring=ring_stats(ring))

        got = run_both(scenario)
        assert got["stats"]["dispatch"]["chains"]["ingress"] == {
            "pkts": 13, "bursts": 4, "stages": 2, "stage_invocations": 8,
            "wqes": 8, "dataflow_msgs": 4, "completed_pkts": 13}
        assert got["stats"]["dispatch"]["dispatch_rounds"] >= 4

    def test_chained_flushes_below_staged_serial_sum(self):
        depth, burst = 16, 4
        frames = _frames(32)

        def scenario(s):
            eng, _, ring, disp, _, _ = _ingress_setup(s, depth=depth,
                                                      burst=burst)
            f0 = eng.stats["flushes"]
            _drive(ring, disp, frames, depth)
            chained = eng.stats["flushes"] - f0

            def single_stage_flushes(stage_wid, rows, slot_bytes, out_row):
                eng = s.RDMAEngine(n_peers=2, pool_size=POOL)
                blk = s.lk.LookasideBlock(eng, peer=LC_PEER,
                                          scratch_base=POOL // 2,
                                          scratch_size=POOL // 4,
                                          eager_writeback=False,
                                          pipeline_depth=4)
                s.K.register_chain_kernels(blk)
                ring = s.S.RXRing(eng, peer=LC_PEER, base=0, depth=depth,
                                  slot_bytes=slot_bytes)
                chain = s.S.Chain((stage_wid,))
                disp = s.S.StreamDispatcher(
                    blk, ring, s.S.MatchTable(default=chain), burst=burst)
                base = slot_bytes * depth + 64
                mr = eng.register_mr(DATA_PEER, base, out_row * depth)
                disp.register_chain(chain, DATA_PEER, mr.rkey, [base])
                f0 = eng.stats["flushes"]
                _drive(ring, disp, rows, depth)
                return eng.stats["flushes"] - f0, snapshot(eng)

            o1 = s.parse_frame_rows(frames)
            a = single_stage_flushes(s.K.CHAIN_PARSE_WORKLOAD, frames,
                                     s.K.FRAME_ROW, s.K.PARSED_ROW)
            b = single_stage_flushes(s.K.CHAIN_DEQUANT_WORKLOAD, o1,
                                     s.K.PARSED_ROW, s.K.HDR_BYTES)
            return {"chained": chained, "staged": a[0] + b[0],
                    "snaps": (snapshot(eng), a[1], b[1])}

        got = run_both(scenario)
        assert (got["chained"], got["staged"]) == (10, 12)

    def test_no_new_shape_buckets_after_chain_warmup(self):
        def scenario(s):
            eng, _, ring, disp, _, _ = _ingress_setup(s)
            t = eng.stats["transport"]
            _drive(ring, disp, _frames(13), DEPTH)
            warm = (t["cache_misses"], t["qdma_cache_misses"])
            _drive(ring, disp, _frames(13, seed=7), DEPTH)
            return dict(snapshot(eng), warm=warm, steady=(
                t["cache_misses"], t["qdma_cache_misses"]))

        got = run_both(scenario)
        assert got["warm"] == got["steady"]

    def test_non_default_chain_coexists_with_orphan_sweep(self):
        def scenario(s):
            eng, blk, ring, _, chain, (s1, s2) = _ingress_setup(s)
            disp = s.S.StreamDispatcher(
                blk, ring, s.S.MatchTable(default=s.S.Drop()).add(
                    chain, udp_dport=9000), burst=4)
            mr = eng.register_mr(DATA_PEER, s1 + POOL // 4,
                                 (s.K.PARSED_ROW + s.K.HDR_BYTES) * DEPTH)
            disp.register_chain(chain, DATA_PEER, mr.rkey,
                                [s1 + POOL // 4, s2 + POOL // 4])
            frames = _frames(4)
            ok = [ring.push(f, cls=chain.tag) for f in frames[:2]]
            ok += [ring.push(f, cls=0x77) for f in frames[2:]]
            n = disp.service()
            return dict(snapshot(eng), ring=ring_stats(ring), ok=ok, n=n,
                        space=ring.space)

        got = run_both(scenario)
        assert all(got["ok"]) and got["n"] == 2
        led = got["stats"]["dispatch"]["chains"]["ingress"]
        assert led["pkts"] == led["completed_pkts"] == 2
        assert got["stats"]["dispatch"]["dispatch_dropped_pkts"] == 2
        assert got["space"] == DEPTH


class TestEgressChain:
    @staticmethod
    def _chain(s, depth=16, burst=8):
        eng = s.RDMAEngine(n_peers=2, pool_size=POOL)
        ch = s.S.GradEgressChain(eng, data_peer=DATA_PEER, ring_base=1024,
                                 out_base=4096, lc_peer=LC_PEER,
                                 scratch_base=POOL // 2,
                                 scratch_size=POOL // 4, depth=depth,
                                 burst=burst)
        return eng, ch

    def test_wire_parity_checksums_and_residual(self):
        flat = np.random.default_rng(2).normal(size=500).astype(np.float32)
        resid0 = np.zeros(500, np.float32)

        def scenario(s):
            eng, ch = self._chain(s)
            q, s_, csum, resid = ch.compress(flat, resid0)
            q_bad = q.copy()
            q_bad[0, 3] += 1
            return dict(snapshot(eng), q=q, s=s_, csum=csum, resid=resid,
                        ok=s.S.GradEgressChain.verify_checksums(q, s_, csum),
                        bad=s.S.GradEgressChain.verify_checksums(q_bad, s_,
                                                                 csum))

        got = run_both(scenario)
        kq, ks, _ = TORCH.C.kops.compress(
            torch.from_numpy(np.pad(flat, (0, 12))), chunk=64)
        np.testing.assert_array_equal(got["q"], kq.numpy())
        np.testing.assert_array_equal(got["s"], ks.numpy())
        assert got["ok"] is True and got["bad"] is False
        _, _, want_resid = tc.compress_bucket(
            torch.from_numpy(flat), torch.from_numpy(resid0), chunk=64)
        np.testing.assert_array_equal(got["resid"], want_resid.numpy())

    def test_multi_window_error_feedback_rounds(self):
        rng = np.random.default_rng(5)
        flats = [rng.normal(size=1280).astype(np.float32) for _ in range(2)]

        def scenario(s):
            eng, ch = self._chain(s, depth=16, burst=8)
            resid = np.zeros(1280, np.float32)
            rounds = []
            for flat in flats:
                q, s_, csum, resid = ch.compress(flat, resid)
                rounds.append((q, s_, csum, resid))
            return dict(snapshot(eng), rounds=rounds)

        got = run_both(scenario)
        want_resid = torch.zeros(1280)
        for flat, (q, s_, csum, resid) in zip(flats, got["rounds"]):
            wq, ws, want_resid = tc.compress_bucket(
                torch.from_numpy(flat), want_resid, chunk=64)
            np.testing.assert_array_equal(q, wq.numpy())
            np.testing.assert_array_equal(s_, ws.numpy())
            np.testing.assert_array_equal(resid, want_resid.numpy())
            assert TORCH.S.GradEgressChain.verify_checksums(q, s_, csum)
        led = got["stats"]["dispatch"]["chains"]["grad_egress"]
        assert led["pkts"] == led["completed_pkts"] == 40
        assert led["stages"] == 2
        assert led["stage_invocations"] == 2 * led["bursts"]
        assert led["dataflow_msgs"] == led["bursts"]


class TestChainChaos:
    def test_ingress_chain_parity_under_seeded_drop(self):
        frames = _frames(13)
        live = list(range(5, 13))

        def scenario(s):
            eng = s.RDMAEngine(n_peers=2, pool_size=POOL, scheduler="drr",
                               flush_budget=8)
            eng.install_fault_injector(
                s.rdma.FaultInjector(3, drop=0.10, corrupt=0.03),
                s.rdma.ReliabilityConfig(retry_cnt=16))
            eng, _, ring, disp, _, (s1, s2) = _ingress_setup(s, eng=eng)
            _drive(ring, disp, frames, DEPTH)
            return dict(snapshot(eng), ring=ring_stats(ring),
                        o1=_stage_rows(eng, s1, s.K.PARSED_ROW, DEPTH, live),
                        o2=_stage_rows(eng, s2, s.K.HDR_BYTES, DEPTH, live))

        got = run_both(scenario)
        o1 = TORCH.parse_frame_rows(frames)
        np.testing.assert_array_equal(got["o1"], o1[live])
        np.testing.assert_array_equal(
            got["o2"], TORCH.dequant_trailing_rows(o1)[live])
        assert got["stats"]["dispatch"]["chains"]["ingress"][
            "completed_pkts"] == 13
        assert got["stats"]["reliability"]["retransmits"] > 0


# ---------------------------------------------------------------------------
# compress.py: the pure error-feedback functions
# ---------------------------------------------------------------------------

def _t(x):
    return torch.from_numpy(np.asarray(x))


class TestRoundtrip:
    @pytest.mark.parametrize("n,chunk", [(1024, 1024), (500, 64),
                                         (64, 64), (130, 64)])
    def test_compress_matches_reference(self, n, chunk):
        flat = np.random.default_rng(n + chunk).normal(size=n).astype(
            np.float32)
        zeros = np.zeros(n, np.float32)
        jq, js, jr = jc.compress_bucket(jnp.asarray(flat),
                                        jnp.asarray(zeros), chunk=chunk)
        q, s, resid = tc.compress_bucket(_t(flat), _t(zeros), chunk=chunk)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(resid.numpy(), np.asarray(jr))
        back = tc.decompress_bucket(q, s, (n,))
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jc.decompress_bucket(jq, js, (n,))))
        rows = -(-n // chunk)
        padded = np.zeros(rows * chunk, np.float32)
        padded[:n] = flat
        wq, ws = ref_quantize(jnp.asarray(padded.reshape(rows, chunk)))
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(ref_dequantize(wq, ws)).reshape(-1)[:n])
        np.testing.assert_array_equal(resid.numpy(), flat - back.numpy())
        bound = np.repeat(s.numpy().reshape(-1), chunk)[:n]
        assert (np.abs(resid.numpy()) <= 0.5 * bound + 1e-7).all()

    def test_zero_chunks_roundtrip_exactly(self):
        q, s, resid = tc.compress_bucket(torch.zeros(128), torch.zeros(128),
                                         chunk=64)
        assert not q.any() and not resid.any()
        np.testing.assert_array_equal(s.numpy(), np.ones((2, 1), np.float32))

    def test_wire_ratio(self):
        for nbytes, chunk in ((4096, 1024), (256, 64), (4100, 1024)):
            assert (tc.compression_ratio(nbytes, chunk)
                    == jc.compression_ratio(nbytes, chunk))
        assert tc.compression_ratio(4096, chunk=1024) == (1024 + 4) / 4096


class TestErrorFeedback:
    def test_residual_rounds_match_reference(self):
        """Fifty rounds of error feedback on a biased stream: every
        round's q, s and residual byte-equal to the reference's, and the
        accumulated drift bounded by one round's error."""
        rng = np.random.default_rng(17)
        n, chunk, rounds = 256, 64, 50
        jr = jnp.zeros(n, jnp.float32)
        tr = torch.zeros(n)
        acc_true = np.zeros(n, np.float64)
        acc_deq = np.zeros(n, np.float64)
        max_scale = 0.0
        for _ in range(rounds):
            flat = rng.normal(size=n).astype(np.float32) + np.float32(0.1)
            jq, js, jr = jc.compress_bucket(jnp.asarray(flat), jr,
                                            chunk=chunk)
            q, s, tr = tc.compress_bucket(_t(flat), tr, chunk=chunk)
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
            acc_true += flat.astype(np.float64)
            acc_deq += tc.decompress_bucket(q, s, (n,)).numpy()
            max_scale = max(max_scale, float(s.max()))
        drift = np.abs(acc_true - acc_deq)
        np.testing.assert_allclose(drift, np.abs(tr.numpy()), rtol=0,
                                   atol=1e-4)
        assert drift.max() <= 0.5 * max_scale + 1e-4

    def test_without_feedback_bias_accumulates(self):
        rng = np.random.default_rng(18)
        n, chunk, rounds = 256, 64, 50
        flat = _t((np.full(n, 0.3, np.float32)
                   * rng.uniform(0.5, 1.0, n).astype(np.float32)))
        q, s, _ = tc.compress_bucket(flat, torch.zeros(n), chunk=chunk)
        per_round = flat - tc.decompress_bucket(q, s, (n,))
        no_fb_drift = float((rounds * per_round).abs().max())
        resid = torch.zeros(n)
        acc = np.zeros(n, np.float64)
        for _ in range(rounds):
            q, s, resid = tc.compress_bucket(flat, resid, chunk=chunk)
            acc += tc.decompress_bucket(q, s, (n,)).numpy()
        fb_drift = np.abs(rounds * flat.numpy().astype(np.float64)
                          - acc).max()
        assert fb_drift <= 0.5 * float(s.max()) + 1e-4
        assert no_fb_drift > 10 * fb_drift

    def test_init_error_state_matches_grad_tree(self):
        grads = {"w": torch.ones((4, 8), dtype=torch.bfloat16),
                 "b": [torch.ones(8), (torch.ones(2, 3),)],
                 "n": np.ones((5,), np.float16)}
        st = tc.init_error_state(grads, device="cpu")
        want = jc.init_error_state(jax.tree.map(
            lambda g: jnp.asarray(np.asarray(
                g.float() if isinstance(g, torch.Tensor) else g)), grads))
        assert set(st) == set(want)
        assert type(st["b"]) is list and type(st["b"][1]) is tuple
        for got, ref in ((st["w"], want["w"]), (st["b"][0], want["b"][0]),
                         (st["b"][1][0], want["b"][1][0]),
                         (st["n"], want["n"])):
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


class TestCompressedAllReduce:
    @staticmethod
    def _both(shards, chunk=64):
        """The JAX body under a vmapped named axis (the single-process
        stand-in for the cross-pod mesh) and the port over its explicit
        peer dimension."""
        resid = np.zeros_like(shards)
        jout, jres = jax.vmap(
            lambda f, r: jc.compressed_all_reduce(f, r, "p", chunk=chunk),
            axis_name="p")(jnp.asarray(shards), jnp.asarray(resid))
        tout, tres = tc.compressed_all_reduce(_t(shards), _t(resid),
                                              chunk=chunk)
        return (np.asarray(jout), np.asarray(jres), tout.numpy(),
                tres.numpy())

    def test_approximates_fp32_mean_within_reference_bound(self):
        peers, n = 4, 256
        shards = np.random.default_rng(31).normal(
            size=(peers, n)).astype(np.float32)
        jout, jres, out, resid = self._both(shards)
        want = shards.mean(axis=0)
        s_arr = np.stack([np.asarray(ref_quantize(jnp.asarray(
            s.reshape(-1, 64)))[1]) for s in shards])
        s_mean = s_arr.mean(axis=0)
        per_chunk = (127.0 * np.abs(s_arr - s_mean).mean(axis=0)
                     + 0.5 * s_mean)
        bound = np.repeat(per_chunk.reshape(-1), 64)[:n]
        assert out.shape == (peers, n) and resid.shape == (peers, n)
        for p in range(peers):
            assert (np.abs(out[p] - want) <= bound + 1e-6).all()
        np.testing.assert_allclose(out, jout, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(resid, jres)

    def test_exact_on_shared_scale_int_grads(self):
        peers, n = 4, 128
        base = np.random.default_rng(32).integers(
            -8, 9, (peers, n)).astype(np.float32)
        base[:, 0::64] = 127.0           # pin every chunk's amax to 127
        jout, _, out, resid = self._both(base)
        for p in range(peers):
            np.testing.assert_allclose(out[p], base.mean(axis=0), rtol=0,
                                       atol=1e-4)
        np.testing.assert_array_equal(out, jout)
        assert not resid.any()

    def test_residual_matches_local_compress(self):
        shards = np.random.default_rng(33).normal(
            size=(2, 128)).astype(np.float32)
        _, jres, _, resid = self._both(shards)
        for p in range(2):
            _, _, want = tc.compress_bucket(_t(shards[p]), torch.zeros(128),
                                            chunk=64)
            np.testing.assert_array_equal(resid[p], want.numpy())
        np.testing.assert_array_equal(resid, jres)

    @pytest.mark.parametrize("n", [192, 200])
    def test_matches_manual_int32_sum(self, n):
        """The estimator is literally sum(int8 as int32) * mean-scale /
        n — checked against a hand-built version, ragged tail included."""
        peers, chunk = 3, 64
        shards = np.random.default_rng(n).normal(
            size=(peers, n)).astype(np.float32)
        jout, _, out, _ = self._both(shards, chunk=chunk)
        qs = [TORCH.C.kops.compress(_t(s), chunk=chunk)[:2] for s in shards]
        q_sum = np.sum([q.numpy().astype(np.int32) for q, _ in qs], axis=0)
        s_mean = np.mean([s.numpy() for _, s in qs], axis=0)
        want = (q_sum.astype(np.float32) * s_mean / peers).reshape(-1)[:n]
        for p in range(peers):
            np.testing.assert_allclose(out[p], want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(out, jout, rtol=0, atol=1e-6)
