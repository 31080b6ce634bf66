"""What the drivers share: the device's sync and relative errors."""
from __future__ import annotations

import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rel_err(got: torch.Tensor, ref: torch.Tensor, dim=None) -> torch.Tensor:
    """||got - ref|| / ||ref|| in f32, over ``dim`` (all of it: None)."""
    got, ref = got.float(), ref.float()
    if dim is None:
        return (got - ref).norm() / ref.norm().clamp_min(1e-30)
    return ((got - ref).norm(dim=dim)
            / ref.norm(dim=dim).clamp_min(1e-30))

