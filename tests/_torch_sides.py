"""Both packages behind one namespace, for the port's streaming parity
tests (``test_torch_streaming.py``, ``test_torch_dispatch.py``,
``test_torch_chains.py``).

``test_torch_kv_serve.py`` uses it too, through each side's ``kv``
(``serve.kv_cache``) module and ``bf16`` dtype.

A test writes its scenario once as ``scenario(side)`` and runs it on
``JAX`` (the reference, Pallas kernels in interpret mode) and on
``TORCH`` (the port on ``device="cpu"``, its kernels' plain versions).
``snapshot`` reduces an engine to comparable host values: the pool, every
QP's CQEs in order, and ``engine.stats`` with QPs matched by creation
order (qp_nums come from a per-package counter) and wall-clock latency
histograms reduced to their sample counts. ``assert_same`` compares two
such values — arrays byte for byte, NaNs equal.
"""
import copy
import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import torch

import repro.core.lookaside as JL
import repro.core.rdma as J
import repro.core.streaming as JS
import repro.core.streaming.compress as JC
import repro.kernels.lc_offload as JK
import repro.serve.kv_cache as JKV
import repro_torch.core.lookaside as TL
import repro_torch.core.rdma as T
import repro_torch.core.streaming as TS
import repro_torch.core.streaming.compress as TC
import repro_torch.kernels.lc_offload as TK
import repro_torch.serve.kv_cache as TKV


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


JAX = types.SimpleNamespace(
    name="jax", rdma=J, lk=JL, S=JS, K=JK, C=JC, kv=JKV, bf16=jnp.bfloat16,
    RDMAEngine=J.RDMAEngine,
    TrafficRouter=JS.TrafficRouter,
    classify_headers=JS.classify_headers,
    parse_frame_rows=lambda rows: _np(JK._parse_frame_rows(rows, True)),
    dequant_trailing_rows=lambda rows: _np(
        JK._dequant_trailing_rows(rows, True)),
    checksum_rows=JK._checksum_rows,
    array=jnp.asarray,
)

TORCH = types.SimpleNamespace(
    name="torch", rdma=T, lk=TL, S=TS, K=TK, C=TC, kv=TKV,
    bf16=torch.bfloat16,
    RDMAEngine=functools.partial(T.RDMAEngine, device="cpu"),
    TrafficRouter=functools.partial(TS.TrafficRouter, device="cpu"),
    classify_headers=functools.partial(TS.classify_headers, device="cpu"),
    parse_frame_rows=lambda rows: _np(TK._parse_frame_rows(
        torch.from_numpy(np.asarray(rows, np.float32)))),
    dequant_trailing_rows=lambda rows: _np(TK._dequant_trailing_rows(
        torch.from_numpy(np.asarray(rows, np.float32)))),
    checksum_rows=lambda rows: _np(TK._checksum_rows(
        torch.from_numpy(np.ascontiguousarray(rows, np.float32)))),
    array=lambda x: torch.from_numpy(np.array(x)),
)

SIDES = (JAX, TORCH)


def snapshot(eng):
    """(pool, per-QP CQEs, stats) of an engine as host values."""
    idx = {q: i for i, q in enumerate(eng.qps)}
    cqes = [[(c.wr_id, idx.get(c.qp_num), c.opcode.value, c.status.value,
              c.byte_len, c.imm) for c in qp.cq]
            for qp in eng.qps.values()]
    stats = copy.deepcopy(eng.stats)
    for key in ("qp_service", "lc_service", "qp_bytes"):
        stats[key] = {idx[q]: v for q, v in stats[key].items()}
    stats["qp_latency_us"] = {idx[q]: sum(h.values())
                              for q, h in stats["qp_latency_us"].items()}
    return {"pool": np.array(eng.pool), "cqes": cqes, "stats": stats}


def ring_stats(ring):
    """An RXRing's counters, its wall-clock latency histogram reduced to
    the number of samples."""
    st = dict(ring.stats)
    st["latency_us"] = sum(st["latency_us"].values())
    return st


def action_key(action):
    """A structured table action as a package-neutral value."""
    return (type(action).__name__, dataclasses.astuple(action))


def router_counters(router):
    return {"pkt": dict(router.pkt_counters),
            "class": {action_key(a): n
                      for a, n in router.class_counters.items()}}


def assert_same(got, want, path="result"):
    """Recursive equality: arrays and tensors byte for byte (NaN equal),
    dicts by key, sequences item by item, the rest with ``==``."""
    if isinstance(want, (np.ndarray, torch.Tensor)) or hasattr(
            want, "__array__") and not isinstance(want, (list, tuple)):
        g, w = _np(got), _np(want)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=path)
    elif isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(map(str, got)),
                                       sorted(map(str, want)))
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def run_both(scenario):
    """Run ``scenario(side)`` on both packages, assert equal results and
    return the port's."""
    want = scenario(JAX)
    got = scenario(TORCH)
    assert_same(got, want)
    return got
