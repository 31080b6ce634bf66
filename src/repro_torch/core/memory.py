"""Buffer/memory management — the reconic-mm + Memory API analogue.

``BufferPool`` is a per-peer allocator over the engine's registered pool
(dev_mem) and host RAM (host_mem), handing out ``MemoryRegion``s with
rkeys. The paper routes accesses by address MSBs (0xa35...); here the
region handle carries the placement, and allocation is an explicit
first-fit free-list (deterministic, test-friendly).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.rdma.verbs import MemoryRegion, Placement


@dataclass
class _Block:
    base: int
    length: int


class BufferPool:
    """First-fit allocator for one peer's pool (dev or host placement)."""

    def __init__(self, engine, peer: int, size: Optional[int] = None):
        self.engine = engine
        self.peer = peer
        self.size = size or engine.pool_size
        self._free: Dict[Placement, List[_Block]] = {
            Placement.DEV_MEM: [_Block(0, self.size)],
            Placement.HOST_MEM: [_Block(0, self.size)],
        }
        self.regions: Dict[int, MemoryRegion] = {}

    def alloc(self, length: int,
              placement: Placement = Placement.DEV_MEM) -> MemoryRegion:
        free = self._free[placement]
        for i, blk in enumerate(free):
            if blk.length >= length:
                mr = self.engine.register_mr(self.peer, blk.base, length,
                                             placement)
                blk.base += length
                blk.length -= length
                if blk.length == 0:
                    free.pop(i)
                self.regions[mr.rkey] = mr
                return mr
        raise MemoryError(
            f"peer {self.peer} {placement.value}: no block of {length} "
            f"(free: {[(b.base, b.length) for b in free]})")

    def free(self, mr: MemoryRegion) -> None:
        self.engine.invalidate_mr(mr.rkey)
        self.regions.pop(mr.rkey, None)
        free = self._free[mr.placement]
        free.append(_Block(mr.base, mr.length))
        # coalesce adjacent blocks
        free.sort(key=lambda b: b.base)
        merged: List[_Block] = []
        for b in free:
            if merged and merged[-1].base + merged[-1].length == b.base:
                merged[-1].length += b.length
            else:
                merged.append(b)
        self._free[mr.placement] = merged

    def write(self, mr: MemoryRegion, data, offset: int = 0) -> None:
        assert offset + len(data) <= mr.length, "write past region"
        self.engine.write_buffer(self.peer, mr.base + offset, data,
                                 mr.placement)

    def read(self, mr: MemoryRegion, length: Optional[int] = None,
             offset: int = 0):
        length = mr.length - offset if length is None else length
        return self.engine.read_buffer(self.peer, mr.base + offset, length,
                                       mr.placement)

    def utilization(self, placement: Placement = Placement.DEV_MEM) -> float:
        free = sum(b.length for b in self._free[placement])
        return 1.0 - free / self.size
