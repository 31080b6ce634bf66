"""Training's mesh paths in the port against the JAX package, on the CPU.

The port's steps run as gloo ranks (``run_peers``): one spawn of four
ranks on a (2, 2) ("data", "model") mesh for the psum bucketed step, its
collective count and ``make_train_step(mesh)`` with and without ZeRO-1,
and one spawn of two ranks on a (2, 1) ("pod", "data") mesh for the
compressed step and ``sync="rdma"`` with ``n_peers`` from the mesh. The
references run in this process on one JAX CPU device:

- the psum step: the mean over data-parallel shards of the JAX
  package's per-shard loss and gradients (``_microbatch_grads`` on each
  shard, what its ``shard_map`` body computes), then its clip and
  ``adamw_update``;
- ``make_train_step(mesh)``, ZeRO-1 or not: the JAX plain step on the
  global batch;
- the compressed path: the reference's ``compressed_all_reduce`` formula
  (compress, sum the codes and the scales, dequantize the mean) applied
  per pod, times the number of pods: the port sums over pods where the
  reference takes the mean and so halves the gradient on two pods
  (ROADMAP Queue 3, pinned by ``test_compressed_step_sums_over_pods``).

Tolerances (``tests/test_torch_train.py``'s): the loss within 1e-5
relative, gradient leaves within 2e-5 of the leaf's largest |value|,
parameters within 1e-5; AdamW's ``v`` within twice the gradients' (it
is quadratic in them). ``compressed_all_reduce_group`` on given buckets
is bit-equal to the reference formula. Through a whole step the int8
quantizer is discontinuous, so a code may round the other way where the
two gradients straddle a rounding boundary: there the synced gradient
may differ by one code's worth of the mean scale (the pods' sum moves
by the mean scale a code) and the residual by one step of its own
scale, and the update is then held against the reference optimizer
applied to the port's own synced gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
import repro.models as JM
import repro.train as JTR
import repro.train.optimizer as JOPT
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_config as jax_config
from repro.core.rdma.doorbell import plan_buckets as j_plan_buckets
from repro.core.streaming import compress as JC
from repro.models.sharding import param_specs as j_param_specs
from repro.train.train_step import _bucketize as j_bucketize
from repro.train.train_step import _microbatch_grads as j_microbatch_grads
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.streaming.compress import (compress_bucket,
                                                 decompress_bucket)
from repro_torch.launch.mesh import run_peers
from repro_torch.models import params_from_jax
from repro_torch.models.sharding import param_specs
from repro_torch.train import make_bucketed_train_step
from repro_torch.train.optimizer import zero1_leaf_spec, zero1_specs
from repro_torch.train.train_step import bucketed_sync

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
PARAM_TOL = 1e-5
OPT_TOL = 1e-6
SPAWN_TIMEOUT_S = 240
STEPS = 10
BASE = dict(learning_rate=3e-3, warmup_steps=1, total_steps=20, remat=False,
            zero1=False, sequence_parallel=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """The JAX package's tiny weights (key 0) and the global batch of
    ``test_distributed.py``'s bucketed step (8 x 32 from seed 0)."""
    jp = JM.init_params(jax_config("tiny"), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (8, 32)).astype(np.int32),
             "labels": rng.integers(0, 256, (8, 32)).astype(np.int32)}
    return jp, batch


@pytest.fixture(scope="module")
def data_model(tiny):
    jp, batch = tiny
    return run_peers(R.mesh_train_cases, 4, device="cpu",
                     timeout_s=SPAWN_TIMEOUT_S, args=(_np(jp), batch, STEPS))


def _flats(zero_chunks=False):
    """Two pods' (bucket, residual) of 1000 words. ``zero_chunks``: the
    first 256-word chunk all zero on pod 0, the second on both."""
    rng = np.random.default_rng(5)
    flats = [(rng.standard_normal(1000).astype(np.float32),
              (rng.standard_normal(1000) * 1e-2).astype(np.float32))
             for _ in range(2)]
    if zero_chunks:
        for pod, cut in ((0, slice(0, 512)), (1, slice(256, 512))):
            for x in flats[pod]:
                x[cut] = 0.0
    return flats


@pytest.fixture(scope="module")
def pod_data(tiny):
    jp, batch = tiny
    return run_peers(R.pod_train_cases, 2, device="cpu",
                     timeout_s=SPAWN_TIMEOUT_S, args=(_np(jp), batch,
                                                      _flats(),
                                                      _flats(True)))


def _shards(batch, n):
    m = batch["tokens"].shape[0] // n
    return [{k: jnp.asarray(v[i * m:(i + 1) * m]) for k, v in batch.items()}
            for i in range(n)]


def _close(got, want, tol, what, rel=True):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, what
        scale = max(float(np.abs(w).max()), 1e-30) if rel else 1.0
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=what)


def _shard_grads(jp, batch, n, tcfg):
    """The JAX package's loss and gradients of each of ``n`` shards."""
    fn = jax.jit(lambda p, b: j_microbatch_grads(p, jax_config("tiny"), b,
                                                 tcfg))
    return [fn(jp, b) for b in _shards(batch, n)]


def _update(tcfg):
    """The reference's clip and AdamW, jitted."""
    return jax.jit(lambda g, o, p: JOPT.adamw_update(
        JOPT.clip_by_global_norm(g, tcfg.grad_clip)[0], o, p, tcfg))


def _psum_reference(jp, batch, n, tcfg):
    """The reference's shard_map step: per-shard loss and grads, their
    mean, clip, AdamW."""
    outs = _shard_grads(jp, batch, n, tcfg)
    loss = sum(float(o[0]) for o in outs) / n
    grads = jax.tree.map(lambda *g: sum(x / n for x in g),
                         *[o[1] for o in outs])
    params, _ = _update(tcfg)(grads, JTR.init_adam(jp), jp)
    return loss, grads, params


# ---------------------------------------------------------------------------
# (2, 2) ("data", "model"): psum, collective counts, ZeRO-1
# ---------------------------------------------------------------------------

def test_ranks_of_a_mesh_agree(data_model):
    """SPMD: every rank ends with the same losses and parameters, the
    model axis replicated."""
    assert [tuple(r["coords"]) for r in data_model] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in data_model[1:]:
        assert r["losses"] == data_model[0]["losses"]
        for a, b in zip(tree_leaves(r["params1"]),
                        tree_leaves(data_model[0]["params1"])):
            assert np.array_equal(a, b)


def test_psum_step_matches_the_per_shard_reference(tiny, data_model):
    """Step 1 of the psum bucketed step against the mean of the JAX
    package's per-shard gradients, its clip and AdamW."""
    jp, batch = tiny
    tcfg = JTrainConfig(grad_bucket_mb=0.125, **BASE)
    loss, grads, params = _psum_reference(jp, batch, 2, tcfg)
    r = data_model[0]
    assert abs(r["losses"][0] - loss) <= LOSS_RTOL * abs(loss)
    _close(r["grads1"], grads, GRAD_TOL, "synced grads")
    _close(r["params1"], params, PARAM_TOL, "params after step 1",
           rel=False)


def test_psum_step_loss_falls(data_model):
    losses = data_model[0]["losses"]
    assert len(losses) == STEPS and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_zero1_step_refuses_whole_state(data_model):
    """The ZeRO-1 step takes this rank's cut of m and v only: whole state
    raises on every rank, before any collective."""
    for r in data_model:
        assert "zero1_init" in r["zero1_whole_state"]


def test_bucketed_collective_count_matches_buckets(tiny, data_model):
    """One all-reduce per bucket plus the loss's, at 0.125 and 100 MiB
    buckets, the buckets planned as the reference plans them."""
    jp, _ = tiny
    for mb, (issued, buckets) in data_model[0]["counts"].items():
        assert issued == buckets + 1, (mb, issued, buckets)
        jb = j_plan_buckets([l.size * l.dtype.itemsize
                             for l in jax.tree.leaves(jp)],
                            int(mb * (1 << 20)))
        assert buckets == len(jb), mb
    assert data_model[0]["counts"][0.125][1] > 1


@pytest.mark.parametrize("zero1", [False, True])
def test_mesh_train_step_matches_the_plain_reference(tiny, data_model,
                                                     zero1):
    """make_train_step(mesh) against the JAX plain step on the global
    batch (two steps); under ZeRO-1 each rank's m and v are its cut, as
    ``zero1_leaf_spec`` gives it, of the reference's."""
    jp, batch = tiny
    tcfg = JTrainConfig(**{**BASE, "zero1": zero1})
    step = jax.jit(JTR.make_train_step(jax_config("tiny"), tcfg))
    p, o = jp, JTR.init_adam(jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        loss, p, o = step(p, o, jb)
    specs = j_param_specs(jp)
    for r in data_model:
        got = r[f"zero1={zero1}"]
        assert abs(got["loss"] - float(loss)) <= LOSS_RTOL * abs(float(loss))
        _close(got["params"], p, PARAM_TOL, "params", rel=False)
        # one all-reduce per gradient leaf and the loss's
        assert got["collectives"] == len(jax.tree.leaves(jp)) + 1
        data = r["coords"][0]
        for key, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL)):
            want = jax.tree.map(np.asarray, getattr(o, key))
            flat_spec = jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                    PartitionSpec))
            for g, w, s in zip(tree_leaves(got[key]),
                               jax.tree.leaves(want), flat_spec):
                spec = zero1_leaf_spec(tuple(s), w.shape, ("data",), 2)
                if zero1 and "data" in spec:
                    d = spec.index("data")
                    n = w.shape[d] // 2
                    w = np.take(w, range(data * n, (data + 1) * n), axis=d)
                assert g.shape == w.shape, (key, spec)
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=tol * max(float(np.abs(w).max()),
                                                 1e-30))


# ---------------------------------------------------------------------------
# (2, 1) ("pod", "data"): compressed sync, rdma with n_peers from the mesh
# ---------------------------------------------------------------------------

def _reference_formula(flats, chunk, live_mean=False):
    """The reference's ``compressed_all_reduce`` per pod: each pod's
    (est, new residual), the mean scale, and each pod's codes at the
    mean scale less its target (bucket plus residual). ``live_mean``:
    the port's mean scale, over the pods whose chunk is not all zero
    (ROADMAP Queue 3)."""
    parts = [JC.compress_bucket(jnp.asarray(f), jnp.asarray(r), chunk=chunk)
             for f, r in flats]
    n = len(flats)
    q_sum = sum(q.astype(jnp.int32) for q, _, _ in parts)
    if live_mean:
        live = [np.asarray(q).any(axis=1, keepdims=True) for q, _, _ in parts]
        s_sum = sum(np.where(lv, np.asarray(s), np.float32(0))
                    for lv, (_, s, _) in zip(live, parts))
        count = sum(lv.astype(np.float32) for lv in live)
        s_mean = jnp.asarray(s_sum / np.maximum(count, np.float32(1)))
    else:
        s_mean = sum(s for _, s, _ in parts) / n
    est = (q_sum.astype(jnp.float32) * s_mean / n).reshape(-1)[
        :flats[0][0].shape[0]]
    errs = []
    for (f, r), (q, _, _) in zip(flats, parts):
        target = np.zeros(q.size, np.float32)
        target[:f.size] = f + r
        errs.append(np.asarray(q, np.float32) * np.asarray(s_mean)
                    - target.reshape(q.shape))
    return [(np.asarray(est), np.asarray(res)) for _, _, res in parts], (
        np.asarray(s_mean)), errs


def test_compressed_all_reduce_group_is_the_reference_formula(pod_data):
    flats = _flats()
    want, _, _ = _reference_formula(flats, 256)
    for pod, r in enumerate(pod_data):
        np.testing.assert_array_equal(r["group_est"], want[pod][0])
        np.testing.assert_array_equal(r["group_res"], want[pod][1])


def test_compressed_all_reduce_group_skips_zero_chunks(pod_data):
    """A chunk that is all zero on one pod adds no scale to the mean: the
    group's estimate there is the other pod's codes at its own scale,
    the true mean within half a code. The reference averages K1's scale
    1.0 of the zero chunk in and lands far off (ROADMAP Queue 3). A
    chunk zero on both pods gives 0 either way."""
    flats = _flats(zero_chunks=True)
    want, _, _ = _reference_formula(flats, 256, live_mean=True)
    ref, _, _ = _reference_formula(flats, 256)
    true = (flats[0][0] + flats[0][1] + flats[1][0] + flats[1][1]) / 2
    for pod, r in enumerate(pod_data):
        np.testing.assert_array_equal(r["sparse_est"], want[pod][0])
        np.testing.assert_array_equal(r["sparse_res"], want[pod][1])
    step = float(np.abs(flats[1][0][:256] + flats[1][1][:256]).max()) / 127
    assert np.abs(want[0][0][:256] - true[:256]).max() <= step / 4
    assert np.abs(ref[0][0][:256] - true[:256]).max() > 10.0
    assert not want[0][0][256:512].any() and not ref[0][0][256:512].any()


def _compressed_reference(jp, batch, tcfg, residuals):
    """One compressed psum step of the reference, per pod: grads / 2,
    its buckets, the formula across pods (the intra-pod sum is over one
    rank) with the port's mean scale, times the two pods; returns (loss,
    synced grads, per-pod residuals, per-pod step of the residual
    quantizer, one code of the sum, the compression's error). The
    synced sum is the pods' codes at the mean scale, summed; the error
    is its distance from the pods' targets summed: the norm of the sum
    over pods of their codes at the mean scale less their targets."""
    outs = _shard_grads(jp, batch, 2, tcfg)
    grads = [jax.tree.map(lambda g: g / 2, o[1]) for o in outs]
    leaves = [jax.tree.leaves(g) for g in grads]
    res_leaves = [jax.tree.leaves(r) for r in residuals]
    _, treedef, buckets = j_bucketize(grads[0],
                                      int(tcfg.grad_bucket_mb * (1 << 20)))
    est = [None] * len(leaves[0])
    new_res = [[None] * len(leaves[0]) for _ in range(2)]
    code = [None] * len(leaves[0])
    res_step = [[None] * len(leaves[0]) for _ in range(2)]
    err_sq = 0.0
    for b in buckets:
        flats = [(np.concatenate([np.asarray(leaves[p][i]).ravel()
                                  for i in b.leaf_ids]),
                  np.concatenate([np.asarray(res_leaves[p][i]).ravel()
                                  for i in b.leaf_ids])) for p in range(2)]
        out, s_mean, errs = _reference_formula(flats, 1024, live_mean=True)
        err_sq += float(np.sum((errs[0].astype(np.float64) + errs[1]) ** 2))
        steps = [float(np.abs(f + r).max()) / 127 for f, r in flats]
        off = 0
        for i in b.leaf_ids:
            shape = leaves[0][i].shape
            n = int(np.prod(shape))
            est[i] = out[0][0][off:off + n].reshape(shape) * 2
            for p in range(2):
                new_res[p][i] = out[p][1][off:off + n].reshape(shape)
                res_step[p][i] = steps[p]
            code[i] = float(s_mean.max())
            off += n
    loss = (float(outs[0][0]) + float(outs[1][0])) / 2
    return (loss, est, [treedef.unflatten(r) for r in new_res], res_step,
            code, float(np.sqrt(err_sq)))


def test_compressed_step_against_the_reference_formula(tiny, pod_data):
    """Two compress_grads steps on (2, 1) ("pod", "data"): the loss, the
    synced gradients and each pod's error-feedback residual against the
    reference formula per pod, times the pods (within one int8 code),
    and each update
    against the reference's clip and AdamW of the port's synced
    gradients."""
    jp, batch = tiny
    tcfg = JTrainConfig(compress_grads=True, grad_bucket_mb=0.125, **BASE)
    residuals = [JC.init_error_state(jp)] * 2
    params, opt, update = jp, JTR.init_adam(jp), _update(tcfg)
    for k in range(2):
        loss, est, new_res, res_step, code, _ = _compressed_reference(
            params, batch, tcfg, residuals)
        for pod, r in enumerate(pod_data):
            got = r["compressed"][k]
            assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss), k
            for g, w, c in zip(tree_leaves(got["grads"]), est, code):
                tol = GRAD_TOL * float(np.abs(w).max()) + c
                np.testing.assert_allclose(g, w, rtol=0, atol=tol)
                assert np.mean(np.abs(g - w) > GRAD_TOL * float(
                    np.abs(w).max())) < 1e-3
            for g, w, st in zip(tree_leaves(got["residuals"]),
                                jax.tree.leaves(new_res[pod]),
                                res_step[pod]):
                np.testing.assert_allclose(
                    g, np.asarray(w), rtol=0,
                    atol=GRAD_TOL * float(np.abs(w).max()) + st)
            assert got["collectives"] > 0
        # the update of the port's own synced gradients, by the reference
        synced = jax.tree.unflatten(jax.tree.structure(jp), [
            jnp.asarray(g) for g in tree_leaves(pod_data[0]["compressed"][k]
                                                ["grads"])])
        params, opt = update(synced, opt, params)
        for r in pod_data:
            _close(r["compressed"][k]["params"], params, PARAM_TOL,
                   f"params after compressed step {k + 1}", rel=False)
        # the next step starts from the port's parameters and residuals
        params = jax.tree.unflatten(jax.tree.structure(jp), [
            jnp.asarray(x) for x in tree_leaves(
                pod_data[0]["compressed"][k]["params"])])
        residuals = [jax.tree.unflatten(jax.tree.structure(jp), [
            jnp.asarray(x) for x in tree_leaves(
                r["compressed"][k]["residuals"])]) for r in pod_data]
    assert any(np.abs(x).max() > 0 for x in tree_leaves(
        pod_data[0]["compressed"][0]["residuals"]))


def test_compressed_step_sums_over_pods(tiny, pod_data):
    """The compressed step syncs the mean gradient, as the uncompressed
    psum step does: step 1's synced norm is the psum step's within the
    compression's error (the distance of the plain formula's sum from
    the pods' targets summed). The reference's mean over the two pods
    (half the port's sum) lies outside it (ROADMAP Queue 3)."""
    jp, batch = tiny
    tcfg = JTrainConfig(compress_grads=True, grad_bucket_mb=0.125, **BASE)
    _, est, _, _, _, bound = _compressed_reference(
        jp, batch, tcfg, [JC.init_error_state(jp)] * 2)
    psum = pod_data[0]["psum_grad_norm"]
    reference = float(np.sqrt(sum(np.sum((w / 2) ** 2) for w in est)))
    for r in pod_data:
        got = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                for g in tree_leaves(
                                    r["compressed"][0]["grads"]))))
        assert abs(got - psum) <= bound, (got, psum, bound)
    assert abs(reference - psum) > bound, (reference, psum, bound)


def test_rdma_step_takes_n_peers_from_the_mesh(tiny, pod_data):
    """sync="rdma" on a ("pod", "data") mesh of 2 ranks: 2 peers, the
    engine an ICITransport, the step equal to the JAX rdma step."""
    jp, batch = tiny
    cfg = dict(BASE, grad_bucket_mb=0.0625)
    jstep = JTR.make_bucketed_train_step(
        jax_config("tiny"), JTrainConfig(**cfg), None, sync="rdma",
        n_peers=2)
    jloss, jp1, _, _ = jstep(jp, JTR.init_adam(jp),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             None)
    for r in pod_data:
        got = r["rdma"]
        assert got["type"] == "ICITransport" and got["n_peers"] == 2
        assert abs(got["loss"] - float(jloss)) <= LOSS_RTOL * abs(
            float(jloss))
        _close(got["params"], jp1, PARAM_TOL, "rdma params", rel=False)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_compression_error_feedback_converges():
    """``test_system.py``'s case on the port: accumulated compressed
    grads -> the true grad; equal to the JAX package's accumulation."""
    rng = np.random.default_rng(0)
    g_np = rng.normal(size=(4096,)).astype(np.float32)
    g = torch.from_numpy(g_np)
    residual, acc = torch.zeros_like(g), torch.zeros_like(g)
    jres, jacc = jnp.zeros(4096, jnp.float32), jnp.zeros(4096, jnp.float32)
    n = 20
    for _ in range(n):
        q, s, residual = compress_bucket(g, residual, chunk=256)
        acc = acc + decompress_bucket(q, s, g.shape)
        jq, js, jres = JC.compress_bucket(jnp.asarray(g_np), jres,
                                          chunk=256)
        jacc = jacc + JC.decompress_bucket(jq, js, g_np.shape)
    err = float((acc / n - g).abs().max())
    scale = float(g.abs().max())
    assert err < scale * 0.02, (err, scale)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


def test_bucketed_sync_compress_without_residuals_raises():
    with pytest.raises(ValueError, match="residuals"):
        bucketed_sync({"w": torch.ones(8)}, ("pod", "data"), 1 << 20,
                      compress=True, mesh=None)
    with pytest.raises(ValueError, match="psum' needs a mesh"):
        make_bucketed_train_step(get_config("tiny"), TrainConfig(), None,
                                 sync="psum")


SPEC_ARCHS = ["tiny", "tiny-moe", "tiny-ssm"] + [a + "-smoke"
                                                for a in J_ARCHS]


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_and_zero1_specs_equal_the_reference(arch):
    jc = jax_config(arch)
    jp = jax.eval_shape(lambda: JM.init_params(jc, jax.random.PRNGKey(0)))
    shapes = jax.tree.map(lambda x: np.zeros(x.shape, np.float32)
                          if x.ndim else np.float32(0), jp)
    tp = params_from_jax(shapes, device="cpu")
    jspecs = j_param_specs(jp)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    want = jax.tree.leaves(jax.tree.map(tuple, jspecs, is_leaf=is_spec),
                           is_leaf=lambda x: isinstance(x, tuple))
    got = tree_leaves(param_specs(tp))
    assert got == want
    for axes, size in ((("data",), 2), (("pod", "data"), 4)):
        jz = JOPT.zero1_specs(jp, jspecs, axes, size)
        wantz = jax.tree.leaves(jax.tree.map(tuple, jz, is_leaf=is_spec),
                                is_leaf=lambda x: isinstance(x, tuple))
        assert tree_leaves(zero1_specs(tp, param_specs(tp), axes,
                                       size)) == wantz
