"""Device and dtype resolution for the port's entry points.

Entry points take ``device=None`` to mean the GPU. Without a CUDA device
they raise rather than carry on quietly on the CPU; callers that want the
host path (the CPU tests) pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises when no CUDA device is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the datapath on the host")
        return torch.device("cuda")
    return torch.device(device)


def rank_device(rank: int,
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The device of process-group rank ``rank``: ``None`` -> the GPU
    ``cuda:{rank % device_count}`` (so ranks share the cards round-robin,
    several on one card), raising without one; a ``cuda`` device without
    an index takes the same slot; anything else passes through."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype (or a torch dtype, passed through) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (numpy-representable ones only)."""
    return torch.empty(0, dtype=dtype).numpy().dtype
