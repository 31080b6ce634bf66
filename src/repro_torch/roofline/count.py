"""Operation counter: FLOPs, bytes and peak live bytes of one traced call.

``OpCounter`` is a ``TorchDispatchMode``: every aten op that runs inside
``with OpCounter(inputs):`` passes through it, on whatever device the
tensors lie (``meta`` included, where nothing is computed). It totals:

* **FLOPs** by the matmul-family formulas of ``torch.utils.flop_counter``
  (its ``flop_registry``: ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions, SDPA); every other op counts none.
* **Bytes** as the inputs plus the outputs of every op, each tensor at
  its own elements times its item size (an input at most at its
  storage's bytes, so a broadcast view is read once). Two kinds of op
  are left
  out: pure views (an op that mutates nothing and whose output shares
  storage with an input: ``view``, ``expand``, ``detach``,
  ``_unsafe_view`` ...) and the allocations that touch no memory
  (``empty`` and its kin). In eager PyTorch every other op reads its
  inputs from and writes its outputs to device memory, so nothing is
  waived as fused; an in-place op counts its mutated input as read and
  written.
* **Peak live bytes**: the storages of the inputs given at entry, plus
  each new storage an op returns from then until it dies (a weakref
  finalizer takes it off), at their largest sum.
* **Hand kernels** through ``charge``: each kernel wrapper charges its
  own formula (``*_cost`` beside the kernel) before it picks a device
  branch, and the ops inside the branch (the plain version on the CPU,
  the launch's allocations on the GPU, shape-only outputs on ``meta``)
  add no FLOPs or bytes, though their storages count towards the peak.
  So a kernel call counts the same work on every device, and the same
  whatever implements it.

Collectives are not ops here: the dry-run plans them
(``launch/mesh.PlanGroup``).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
#: allocations that read and write nothing
NO_TOUCH = frozenset({_aten.empty.memory_format, _aten.empty_strided.default,
                      _aten.new_empty.default,
                      _aten.new_empty_strided.default,
                      _aten.empty_like.default})


def read_bytes(t: torch.Tensor) -> int:
    """The bytes an op reads of input ``t``: its own elements times its
    item size, at most its storage's bytes."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _tensors(tree, out=None) -> list:
    """The tensors in an op's (nested list, tuple or dict) arguments or
    results."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class OpCounter(TorchDispatchMode):
    """Totals of the ops run inside ``with OpCounter(inputs):`` (see the
    module docstring): ``flops``, ``bytes``, ``peak_bytes``,
    ``input_bytes`` (the storages of ``inputs`` at entry) and
    ``kernels`` (name -> {"calls", "flops", "bytes"} of the hand kernels
    charged)."""

    def __init__(self, inputs=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}
        self._quiet = 0
        for t in _tensors(inputs):
            self._track(t)
        self.input_bytes = self.live

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._storages:
            return
        n = storage.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(storage, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def charge(self, name: str, flops: int, nbytes: int) -> None:
        """Add one call of hand kernel ``name`` at its own formula's
        ``flops`` and ``nbytes``."""
        self.flops += flops
        self.bytes += nbytes
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def totals(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak_bytes,
                "input_bytes": self.input_bytes,
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())}}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not self._quiet and func not in NO_TOUCH:
            ins = _tensors((args, kwargs))
            held = {t.untyped_storage()._cdata for t in ins}
            if func._schema.is_mutable or not any(
                    o.untyped_storage()._cdata in held for o in outs):
                self.bytes += (sum(read_bytes(t) for t in ins)
                               + sum(o.numel() * o.element_size()
                                     for o in outs))
                counted = flop_registry.get(func._overloadpacket)
                if counted is not None:
                    self.flops += int(counted(*args, **kwargs,
                                              out_val=out))
        for o in outs:
            self._track(o)
        return out


def active_counters():
    """The ``OpCounter``s active in this thread, innermost last."""
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, OpCounter)]


@contextlib.contextmanager
def charge(name: str, cost: Callable, *args, **kwargs):
    """A kernel wrapper's hook, around its device branches: with an
    ``OpCounter`` active, charge one call of ``name`` at ``cost(*args,
    **kwargs)`` -> (flops, bytes) (reckoned only then) and keep the ops
    inside from counting FLOPs or bytes."""
    counters = active_counters()
    if not counters:
        yield
        return
    flops, nbytes = cost(*args, **kwargs)
    for c in counters:
        c.charge(name, int(flops), int(nbytes))
        c._quiet += 1
    try:
        yield
    finally:
        for c in counters:
            c._quiet -= 1
