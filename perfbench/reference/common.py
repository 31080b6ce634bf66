"""Plain PyTorch pieces of the references: float32 throughout, TF32 off
(the harness turns it off before a reference runs), no kernel, no
cache manager and nothing of the program under test.

A share is one rank of the deployment's ``model`` axis, run on one chip
with no other rank present: a collective that sums over the ranks
(all-reduce) hands back the rank's own partial sum, and one that joins
the ranks' parts (all-gather) joins copies of its own part, as each
rank would if every other held the same values. The references compute
exactly that share, with ``tile`` for a join.

``Prec`` rounds the operands of every product: ``f32`` keeps them,
``fp8`` rounds them to float8 e4m3 with a scale per row of the left
operand and per column of the right one (the precision below bfloat16
that a faster product would use); the harness runs the latter as the
control that the comparison has to fail.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = float("-inf")


class Prec:
    """The rounding of products' operands: ``"f32"`` or ``"fp8"``."""

    def __init__(self, name: str = "f32"):
        assert name in ("f32", "fp8"), name
        self.name = name

    def _round(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.name == "f32":
            return x
        amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).to(F32) / scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` in f32, ``a`` rounded by its rows and ``b`` by its
        columns (batch dims lead)."""
        a, b = a.to(F32), b.to(F32)
        return self._round(a, -1) @ self._round(b, -2)


def tile(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """An all-gather of ``n`` ranks on a lone rank: its part ``n`` times
    along ``dim``."""
    return torch.cat([x] * n, dim=dim)


def part(x: torch.Tensor, n: int, rank: int, dim: int) -> torch.Tensor:
    """Rank ``rank`` of ``n``'s equal part of ``x`` along ``dim``."""
    m = x.shape[dim] // n
    return x.narrow(dim, rank * m, m)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    x = x.to(F32)
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.to(F32)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding of x (B, S, H, d) at ``positions`` (B, S): dim i
    turns with dim i + d / 2 at frequency theta^(-2i / d)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=F32,
                                        device=x.device) / d))
    ang = positions.to(F32)[..., None] * inv                 # (B, S, d/2)
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x, w_gate, w_up, w_down, prec: Prec):
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def attend(q, k, v, *, q_pos: torch.Tensor, k_len: int, window: int,
           scale: float, prec: Prec, block: int = 4096):
    """Causal attention of q (B, Sq, Hq, d) at key positions ``q_pos``
    (Sq,) over the first ``k_len`` keys of k (B, S, Hkv, d) and v (B, S,
    Hkv, dv); ``window`` > 0 keeps the keys less than ``window`` before
    a query. Hq / Hkv q heads share a kv head. Query blocks of
    ``block`` rows, each over the keys it can see, so the scores fit."""
    b, sq, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    g = hq // hkv
    out = torch.empty((b, sq, hq, dv), dtype=F32, device=q.device)
    for r0 in range(0, sq, block):
        r1 = min(sq, r0 + block)
        p_lo = int(q_pos[r0])
        p_hi = int(q_pos[r1 - 1])
        k0 = max(0, p_lo - window + 1) if window > 0 else 0
        k1 = min(k_len, p_hi + 1)
        qb = q[:, r0:r1].to(F32).reshape(b, r1 - r0, hkv, g, d)
        qb = qb.permute(0, 2, 3, 1, 4)                   # b, hkv, g, sq, d
        kb = k[:, k0:k1].to(F32).permute(0, 2, 3, 1)     # b, hkv, d, sk
        vb = v[:, k0:k1].to(F32).permute(0, 2, 1, 3)     # b, hkv, sk, dv
        s = prec.mm(qb.reshape(b, hkv, g * (r1 - r0), d), kb) * scale
        s = s.reshape(b, hkv, g, r1 - r0, k1 - k0)
        kp = torch.arange(k0, k1, device=q.device)
        qp = q_pos[r0:r1].to(q.device)[:, None]
        mask = kp[None, :] <= qp
        if window > 0:
            mask &= (qp - kp[None, :]) < window
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = prec.mm(p.reshape(b, hkv, g * (r1 - r0), k1 - k0), vb)
        out[:, r0:r1] = o.reshape(b, hkv, g, r1 - r0, dv).permute(
            0, 3, 1, 2, 4).reshape(b, r1 - r0, hq, dv)
    return out
