"""The port's dry-run specs (``repro_torch.launch.specs``) against the
reference's (``repro.launch.specs``).

For every (arch x shape) cell, ``train_input_specs`` and
``serve_input_specs`` give the reference's keys, shapes and dtypes,
caches included (the port's are ``meta`` tensors, the reference's
``ShapeDtypeStruct``s). On the ``single``, ``multi`` and
``2x4:data,model`` meshes the partition functions give the reference's
``PartitionSpec``s as tuples; the reference side takes a stand-in mesh
that carries ``axis_names`` and ``shape``, all its functions read.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.registry import ARCHS as J_ARCHS
from repro.launch import specs as JS
from repro.models.sharding import param_specs as j_param_specs
from repro.models.transformer import init_params as j_init_params

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import specs as TS
from repro_torch.launch.dryrun import mesh_config
from repro_torch.models import init_params
from repro_torch.models.sharding import param_specs

CELLS = [(a, s) for a in J_ARCHS for s in J_SHAPES]
MESHES = ["single", "multi", "2x4:data,model"]


def j_mesh(kind):
    """The reference's view of a mesh: axis names and sizes."""
    m = mesh_config(kind)
    return SimpleNamespace(axis_names=m.axes, shape=dict(zip(m.axes,
                                                             m.shape)))


def described(tree):
    """{key: (shape, dtype name)} of a tree of tensors or
    ``ShapeDtypeStruct``s."""
    if isinstance(tree, dict):
        return {k: described(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(np.dtype(tree.dtype)) if not isinstance(
        tree.dtype, torch.dtype) else str(tree.dtype).split(".")[-1])


def as_tuples(tree):
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    return tree


def port_specs(arch, shape):
    cfg, sh = get_config(arch), SHAPES[shape]
    if sh.kind == "train":
        return TS.train_input_specs(cfg, sh)
    return TS.serve_input_specs(cfg, sh, sh.kind)


def ref_specs(arch, shape):
    cfg, sh = J_ARCHS[arch], J_SHAPES[shape]
    if sh.kind == "train":
        return JS.train_input_specs(cfg, sh)
    return JS.serve_input_specs(cfg, sh, sh.kind)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    got, want = port_specs(arch, shape), ref_specs(arch, shape)
    assert described(got) == described(want)
    assert all(t.device.type == "meta" for t in leaves(got))


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_cache_specs_equal_the_reference(arch, shape, mesh):
    sh = SHAPES[shape]
    got = TS.batch_spec_tree(get_config(arch), port_specs(arch, shape),
                             mesh_config(mesh), sh.global_batch)
    want = JS.batch_spec_tree(J_ARCHS[arch], ref_specs(arch, shape),
                              j_mesh(mesh), sh.global_batch)
    assert got == as_tuples(want)
    assert TS.batch_partition(mesh_config(mesh), sh.global_batch) == \
        JS.batch_partition(j_mesh(mesh), sh.global_batch)


@functools.lru_cache(maxsize=None)
def _param_trees(arch):
    """(the port's params on meta, the reference's abstract params)."""
    return (init_params(get_config(arch), dtype=torch.bfloat16,
                        device="meta"),
            jax.eval_shape(functools.partial(
                j_init_params, J_ARCHS[arch], dtype=jnp.bfloat16),
                jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list(J_ARCHS))
def test_sanitized_param_specs_equal_the_reference(arch, mesh):
    tp, jp = _param_trees(arch)
    got = TS.sanitize_specs(param_specs(tp), tp, mesh_config(mesh))
    want = JS.sanitize_specs(j_param_specs(jp), jp, j_mesh(mesh))
    assert got == as_tuples(want)


@pytest.mark.parametrize("mesh", MESHES)
def test_local_shape_splits_the_batch_where_the_spec_allows(mesh):
    m = mesh_config(mesh)
    dp = int(np.prod([s for a, s in zip(m.axes, m.shape)
                      if a in ("pod", "data")]))
    for sh in SHAPES.values():
        local = TS.local_shape(sh, m)
        if TS.batch_partition(m, sh.global_batch) is None:
            assert local == sh
        else:
            assert local.global_batch * dp == sh.global_batch
            assert (local.seq_len, local.kind) == (sh.seq_len, sh.kind)
