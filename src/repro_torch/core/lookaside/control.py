"""Lookaside Compute control plane (paper §III-B.1).

A control message is "similar to an argument list when invoking a C
function": a workload id, the number of address arguments, and the
addresses. Kernels read their operands from (device/host) memory through
the engine — the LC block's AXI4 data interface — and signal completion
through a status FIFO consumed either by polling or an interrupt handler.
"""
from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ControlMsg:
    """One kernel invocation request (the control-FIFO entry)."""
    workload_id: int
    args: tuple                 # addresses / sizes, kernel-defined
    tag: int = 0                # host-chosen identifier for completion


@dataclass(frozen=True)
class StatusMsg:
    """One completion (the status-FIFO entry). ``retryable=True`` marks a
    transient not-ok status (control-FIFO backpressure): the host should
    drain completions and re-dispatch the same ControlMsg."""
    workload_id: int
    tag: int
    ok: bool
    result_addr: Optional[int] = None
    detail: str = ""
    retryable: bool = False


class FIFO:
    """Bounded FIFO with not-empty signal (maps to the RTL FIFOs).

    ``try_push`` is the hardware-faithful entry point: a full FIFO
    asserts backpressure (returns False) instead of raising — the
    LookasideBlock turns that into a retryable ``StatusMsg(ok=False)``
    rather than letting a RuntimeError unwind the engine loop. ``push``
    keeps the raising behavior for callers that treat overflow as a bug.
    """

    def __init__(self, depth: int = 64):
        self.depth = depth
        self._q: collections.deque = collections.deque()

    def try_push(self, item) -> bool:
        if len(self._q) >= self.depth:
            return False
        self._q.append(item)
        return True

    def push(self, item) -> None:
        if not self.try_push(item):
            raise RuntimeError("FIFO full (backpressure)")

    def pop(self):
        return self._q.popleft() if self._q else None

    @property
    def not_empty(self) -> bool:
        return bool(self._q)

    def __len__(self) -> int:
        return len(self._q)
