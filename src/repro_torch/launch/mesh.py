"""Meshes over a ``torch.distributed`` process group, and a launcher of
ranks.

The port of ``repro/launch/mesh.py``. The reference lays a JAX ``Mesh``
over devices of one controller; here every rank is a process (SPMD: each
runs the same program on the same inputs), joined by a gloo group, and a
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over that group's
ranks with named dimensions. The mesh names the group's topology only:
its ``device_type`` is ``"cpu"`` because gloo carries the collectives,
and a rank's tensors lie on its own device (``_device.rank_device``).

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
from typing import Callable, List, Sequence

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
