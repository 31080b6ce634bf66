"""Meshes over a ``torch.distributed`` process group, and a launcher of
ranks.

The port of ``repro/launch/mesh.py``. The reference lays a JAX ``Mesh``
over devices of one controller; here every rank is a process (SPMD: each
runs the same program on the same inputs), joined by a gloo group, and a
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over that group's
ranks with named dimensions. The mesh names the group's topology only:
its ``device_type`` is ``"cpu"`` because gloo carries the collectives,
and a rank's tensors lie on its own device (``_device.rank_device``).

``PlanMesh`` is a mesh with no process group behind it, for the
dry-run: the steps take it where they take a ``DeviceMesh``, run as the
rank at coordinate 0 of every axis, and each collective they would send
is recorded (``PlanGroup``) instead of sent.

``run_peers`` is the counterpart of the reference tests'
``--xla_force_host_platform_device_count``: it spawns ``n`` gloo ranks,
runs a function in each and returns what each returned, raising (with
the failing rank's traceback) as soon as a rank fails or the time runs
out, and killing the others.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch._device import rank_device

DP_AXES = ("pod", "data")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single-pod (16, 16) data x model, or 2-pod (2, 16, 16) pod x data x
    model — 256 ranks a pod, 512 in all. The group must already hold
    exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dimensions named ``axes`` over
    the initialized process group, ranks laid out row-major."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


class PlanGroup:
    """A group of ``size`` ranks of a ``PlanMesh``: a collective on it is
    recorded in ``log`` as (op, operand bytes, group size), in the
    reference's op names. ``rank`` is this process's index in it. An
    all-reduce moves nothing; ``all_gather``, ``reduce_scatter`` and
    ``all_to_all`` below return a new tensor of the result's shape,
    filled from this rank's own part, so a one-device share allocates
    what a device of the mesh would, but its values mean nothing (every
    rank of a plan holds the same values)."""

    def __init__(self, size: int, log: list, axes: tuple = (),
                 axes_log: list = None, rank: int = 0):
        self.size, self.log, self.rank = size, log, rank
        self.axes, self.axes_log = tuple(axes), axes_log

    def record(self, op: str, t: torch.Tensor) -> None:
        self.log.append((op, t.numel() * t.element_size(), self.size))
        if self.axes_log is not None:
            self.axes_log.append(self.axes)


# ---------------------------------------------------------------------------
# Collectives over a group or a PlanGroup
# ---------------------------------------------------------------------------
# Plain functions of a tensor: the result is a new tensor (an all-reduce
# sums in place). Over a process group a CUDA tensor is staged through
# host memory, as ICITransport stages its words: gloo carries them.

def group_size(group) -> int:
    return group.size if isinstance(group, PlanGroup) \
        else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's index in ``group``."""
    return group.rank if isinstance(group, PlanGroup) \
        else dist.get_rank(group)


def _staged(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous()


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` summed (``op="max"``: its maximum) over ``group``, in
    place."""
    if isinstance(group, PlanGroup):
        group.record("all-reduce", t)
        return t
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    if t.device.type == "cpu":
        dist.all_reduce(t, op=red, group=group)
        return t
    h = _staged(t)
    dist.all_reduce(h, op=red, group=group)
    return t.copy_(h)


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    n = group_size(group)
    if isinstance(group, PlanGroup):
        group.record("all-gather", t)
        return torch.cat([t] * n, dim=dim)
    h = _staged(t)
    parts = [torch.empty_like(h) for _ in range(n)]
    dist.all_gather(parts, h, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's cut along ``dim`` (one of ``size`` equal cuts, in rank
    order) of ``t`` summed over ``group``. gloo has no reduce-scatter:
    the group sums the whole and each rank keeps its cut (recorded as
    the reduce-scatter it stands for)."""
    n = group_size(group)
    m = t.shape[dim] // n
    if isinstance(group, PlanGroup):
        group.record("reduce-scatter", t)
        return t.narrow(dim, group.rank * m, m).clone()
    h = _staged(t)
    if h.data_ptr() == t.data_ptr():
        # a CPU tensor stages as itself: the sum must not land in ``t``
        # (a product's output that a selective checkpoint keeps)
        h = h.clone()
    dist.all_reduce(h, group=group)
    return h.narrow(dim, group_rank(group) * m, m).clone().to(t.device)


def all_to_all(t: torch.Tensor, group, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """``t`` cut into ``size`` equal parts along ``split_dim``, part
    ``j`` sent to rank ``j``, and the parts received concatenated along
    ``cat_dim`` in rank order. gloo builds may lack all-to-all (the
    GPU machine's does): the group all-gathers the whole and each rank
    keeps its parts (recorded as the all-to-all it stands for)."""
    n = group_size(group)
    m = t.shape[split_dim] // n
    if isinstance(group, PlanGroup):
        group.record("all-to-all", t)
        part = t.narrow(split_dim, group.rank * m, m)
        return torch.cat([part] * n, dim=cat_dim)
    h = _staged(t)
    parts = [torch.empty_like(h) for _ in range(n)]
    dist.all_gather(parts, h, group=group)
    me = group_rank(group)
    return torch.cat([p.narrow(split_dim, me * m, m) for p in parts],
                     dim=cat_dim).to(t.device)


class PlanMesh:
    """A mesh description, ``shape`` over named ``axes``, that the steps
    take where they take a ``DeviceMesh`` (``make_train_step(mesh=)``,
    ``make_bucketed_train_step``) with no process group: this process is
    the rank at ``coordinate`` (one index an axis; 0 on every axis by
    default), and the collectives the step would send land in
    ``collectives`` as (op, operand bytes, group size) instead of being
    sent, and the axes of each one's group in ``collective_axes``."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 coordinate: Optional[Sequence[int]] = None):
        self.shape = tuple(int(x) for x in shape)
        self.mesh_dim_names = tuple(axes)
        self.coordinate = ([0] * len(self.shape) if coordinate is None
                           else [int(c) for c in coordinate])
        self.collectives: list = []
        self.collective_axes: list = []

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_coordinate(self) -> list:
        return list(self.coordinate)

    def group(self, axes: Sequence[str]) -> PlanGroup:
        n, rank = 1, 0
        for a in axes:
            i = self.mesh_dim_names.index(a)
            n *= self.shape[i]
            rank = rank * self.shape[i] + self.coordinate[i]
        return PlanGroup(n, self.collectives, axes, self.collective_axes,
                         rank)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def dp_axes(mesh: DeviceMesh) -> tuple:
    """The data-parallel axes of ``mesh``, in ("pod", "data") order."""
    return tuple(a for a in DP_AXES if a in mesh.mesh_dim_names)


def dp_size(mesh: DeviceMesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= axis_size(mesh, a)
    return n


def axis_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group over ``axes`` of ``mesh`` that holds this rank
    (the ranks that share its coordinates on every other axis). One axis
    is the mesh's own group; several are flattened into one group, its
    ranks in row-major order of ``axes``, built once per mesh and axes by
    every rank together (``new_subgroups_by_enumeration``)."""
    axes = tuple(axes)
    if isinstance(mesh, PlanMesh):
        return mesh.group(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_reconic_groups", {})
    if axes not in groups:
        names = mesh.mesh_dim_names
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, int(torch.tensor([mesh.size(d) for d in dims]).prod()))
        groups[axes], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return groups[axes]


def dp_group(mesh: DeviceMesh):
    """The group over the data-parallel axes that holds this rank."""
    return axis_group(mesh, dp_axes(mesh))


def dp_rank(mesh: DeviceMesh) -> int:
    """This rank's index along the data-parallel axes (pod-major)."""
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for a in dp_axes(mesh):
        idx = idx * axis_size(mesh, a) + coords[a]
    return idx


def model_size(mesh) -> int:
    """The size of the mesh's ``model`` axis (1 without one)."""
    return (axis_size(mesh, "model") if "model" in mesh.mesh_dim_names
            else 1)


def model_rank(mesh) -> int:
    """This rank's coordinate on the ``model`` axis (0 without one)."""
    if "model" not in mesh.mesh_dim_names:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index("model")]


def model_group(mesh):
    """The group over the ``model`` axis that holds this rank (None
    without a ``model`` axis)."""
    if "model" not in mesh.mesh_dim_names:
        return None
    return axis_group(mesh, ("model",))


# ---------------------------------------------------------------------------
# Ranks in processes
# ---------------------------------------------------------------------------

class PeerError(RuntimeError):
    """A rank raised, died or ran out of time under ``run_peers``."""


def _peer_main(rank: int, n: int, store: str, device, timeout_s: float,
               fn: Callable, args: tuple, results) -> None:
    try:
        dist.init_process_group(
            "gloo", init_method="file://" + store, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s))
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:                       # reported, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_peers(fn: Callable, n: int, *, device="cuda", timeout_s: float = 300.0,
              args: tuple = ()) -> List:
    """Run ``fn(rank, *args)`` in ``n`` spawned processes that form a gloo
    group (a ``file://`` store in a fresh temporary directory), rank *r*
    on ``rank_device(r, device)`` (``"cpu"`` for the host); return their
    results in rank order.

    ``fn`` must be importable by name (a module-level function) and
    return something picklable that lies on the host. Raises
    ``PeerError`` with the rank's traceback when a rank raises, with its
    exit code when one dies without a word, and when ``timeout_s``
    passes; the other ranks are killed first. The process group's own
    timeout is ``timeout_s`` too, so a rank left waiting in a collective
    raises rather than hangs."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="reconic_peers_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_peer_main, args=(
            r, n, os.path.join(tmp, "store"), device, timeout_s, fn,
            tuple(args), results), daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < n:
                try:
                    rank, ok, out = results.get(timeout=0.1)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead and results.empty():
                        raise PeerError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                    if time.monotonic() > deadline:
                        raise PeerError(f"{n - len(got)} of {n} ranks gave "
                                        f"no result in {timeout_s} s")
                    continue
                if not ok:
                    raise PeerError(f"rank {rank} of {n} failed:\n{out}")
                got[rank] = out
        finally:
            for p in procs:
                if len(got) < n and p.is_alive():
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(n)]
