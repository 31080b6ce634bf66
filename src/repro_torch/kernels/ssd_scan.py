"""Mamba-2 (SSD) chunked scan — the SSM prefill's kernel (K7 ``ssd_scan``).

Within fixed-size chunks the scan is a masked quadratic form; across
chunks a ``(head_dim, d_state)`` state per (sequence, head) carries the
recurrence. On the H100 the CUDA kernel (``csrc/ssd_scan.cu``) runs it as
Mamba-2's chunked algorithm in five launches: the in-chunk cumsum (in
order, as the plain version sums it), C·B^T once per (sequence, chunk),
each chunk's state increment, the state passed from chunk to chunk (the
only pass that walks the chunks in order), and each chunk's outputs, with
the products as 3xTF32 on the tensor cores. Unlike the TPU kernel it
replaces, it starts from an optional initial state and returns the final
one, so the model's prefill (seeded from ``cache["ssm"]``) and its
forward without caches both run through it.

``ssd_scan`` runs the plain PyTorch version for tensors on the CPU and
launches the CUDA kernel for tensors on the GPU, where it takes
``n_groups == 1`` only and raises otherwise. The launcher itself refuses
a head or state dim the kernel is not built for and a chunk longer than
its largest (4096), and the wrapper raises on that refusal. The scratch
the passes share is allocated here with ``torch.empty``.
``ssd_scan.launches`` counts the calls that launched the kernel (one per
call, whatever the number of passes). On the GPU the outputs carry a
``grad_fn`` whose backward recomputes the plain version and
differentiates it (``_SSDScan``); the forward stays the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

_DTYPES = (torch.float32, torch.bfloat16)


def _cumsum_in_order(da: torch.Tensor) -> torch.Tensor:
    """Cumsum over dim 2, one step after another, as the CUDA kernel
    sums. The decay ``exp(cum_i - cum_j)`` reads a difference of two
    large sums (|cum| ~ 3000 over a 256-long chunk at a = -16, where one
    f32 step is 2.4e-4), so a scan in another order (``torch.cumsum`` on
    the GPU runs a parallel one) moves it by up to that much; summing in
    one order keeps the two versions within the reference's 2e-5.
    Built with ``torch.stack`` (no in-place writes), so autograd takes it
    as it is."""
    sums = []
    run = torch.zeros_like(da[:, :, 0])
    for i in range(da.shape[2]):
        run = run + da[:, :, i]
        sums.append(run)
    return torch.stack(sums, dim=2)


def ssd_scan_plain(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   bm: torch.Tensor, cm: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None,
                   dtype: torch.dtype = torch.float32):
    """The reference's ``models/ssm._ssd_chunked`` in PyTorch. xh:
    (B, S, nh, hd), dt: (B, S, nh), a: (nh,) negative, bm/cm: (B, S, G, N)
    with ``nh % G == 0`` (head h reads group h // (nh // G)); init_state:
    (B, nh, hd, N) or None for zeros. Computed in ``dtype``: f32, or
    float64 for an oracle of the f32 versions, whose in-chunk cumsum
    stays the f32 one summed in order (the kernel's contract fixes it, and
    ulps of |cum| ~ 3000 would otherwise swamp the products' error).
    Returns (y (B, S, nh, hd), final state (B, nh, hd, N)): in f32, y in
    xh's dtype; in float64, both float64."""
    b, s, nh, hd = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    nc = s // chunk
    hg = nh // g
    ct = dtype
    xc = xh.to(ct).reshape(b, nc, chunk, nh, hd)
    dtc = dt.to(ct).reshape(b, nc, chunk, nh)
    bc = bm.to(ct).reshape(b, nc, chunk, g, n)
    cc = cm.to(ct).reshape(b, nc, chunk, g, n)

    da = dt.float().reshape(b, nc, chunk, nh) * a.float()  # f32 (b,nc,L,nh)
    cum = _cumsum_in_order(da).to(ct)                     # within chunk
    seg_end = cum[:, :, -1]                               # (b,nc,nh)

    # intra-chunk: exp(cum_i - cum_j) for i >= j, masked BEFORE exp
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,L,L,nh)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))
    rel = torch.where(tri[None, None, :, :, None], rel,
                      torch.full((), NEG_INF, dtype=ct, device=xh.device))
    decay = torch.exp(rel)
    cb = torch.einsum("bclgn,bcmgn->bclmg", cc, bc)       # (b,nc,L,L,g)
    cb = torch.repeat_interleave(cb, hg, dim=-1)          # (b,nc,L,L,nh)
    w = cb * decay * dtc[:, :, None, :, :]                # dt_j on source
    y_intra = torch.einsum("bclmh,bcmhd->bclhd", w, xc)

    # chunk states: sum_j exp(seg_end - cum_j) dt_j x_j B_j^T
    w_state = torch.exp(seg_end[:, :, None, :] - cum) * dtc
    bh = torch.repeat_interleave(bc, hg, dim=3)           # (b,nc,L,nh,n)
    states = torch.einsum("bclh,bclhn,bclhd->bchdn", w_state, bh, xc)

    # inter-chunk recurrence, the state before each chunk kept
    seg_decay = torch.exp(seg_end)                        # (b,nc,nh)
    carry = (torch.zeros((b, nh, hd, n), dtype=ct, device=xh.device)
             if init_state is None else init_state.to(ct))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * seg_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (b,nc,nh,hd,n)

    ch = torch.repeat_interleave(cc, hg, dim=3)           # (b,nc,L,nh,n)
    y_inter = torch.einsum("bclhn,bchdn,bclh->bclhd", ch, prev_states,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, s, nh, hd)
    return y.to(xh.dtype if dtype == torch.float32 else dtype), carry


def work_floats(b: int, s: int, nh: int, hd: int, n: int,
                chunk: int) -> int:
    """Floats of scratch the CUDA kernel takes for these shapes (the
    launcher's own count, ``reconic_ssd_scan_work_floats``): the in-chunk
    cumsum in dt's layout, C·B^T as (B, nc, Lp, Lp) with Lp the chunk
    rounded up to 64, and the chunk states as (B, nc, nh, hd, N); 0 for a
    chunk it refuses."""
    return int(_build.library().reconic_ssd_scan_work_floats(
        b, nh, s, hd, n, chunk))


def _check_shapes(xh, dt, a, bm, cm, chunk, init_state):
    if xh.ndim != 4:
        raise ValueError(f"xh must be (B, S, nh, hd), got {tuple(xh.shape)}")
    b, s, nh, hd = xh.shape
    if bm.ndim != 4 or tuple(bm.shape) != tuple(cm.shape) \
            or tuple(bm.shape[:2]) != (b, s) or bm.shape[2] == 0 \
            or nh % bm.shape[2]:
        raise ValueError(f"bm/cm must be (B, S, G, N) with nh % G == 0, "
                         f"got {tuple(bm.shape)}, {tuple(cm.shape)}")
    if tuple(dt.shape) != (b, s, nh) or tuple(a.shape) != (nh,):
        raise ValueError(f"dt must be (B, S, nh) and a (nh,), got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}")
    if chunk <= 0 or s == 0 or s % chunk:
        raise ValueError(f"S = {s} must be a positive multiple of the "
                         f"chunk {chunk}")
    n = bm.shape[3]
    if init_state is not None and tuple(init_state.shape) != (b, nh, hd, n):
        raise ValueError(f"init_state must be {(b, nh, hd, n)}, got "
                         f"{tuple(init_state.shape)}")
    if xh.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: unsupported xh dtype {xh.dtype}")


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None,
             return_final_state: bool = False):
    """xh: (B, S, nh, hd) f32 or bf16, dt: (B, S, nh), a: (nh,), bm/cm:
    (B, S, G, N), init_state: (B, nh, hd, N) or None (zeros); S % chunk
    == 0. Returns y (B, S, nh, hd) in xh's dtype, or (y, final state
    (B, nh, hd, N) f32) with ``return_final_state``.

    On the GPU: G == 1, hd and N among those ``csrc/ssd_scan.cu`` is
    built for and a chunk of at most 4096 (the launcher refuses others,
    and the refusal raises); dt, a, bm, cm and init_state f32 and every
    tensor contiguous, xh 4-byte aligned (a bf16 view at an odd element
    offset raises)."""
    _check_shapes(xh, dt, a, bm, cm, chunk, init_state)
    tensors = [xh, dt, a, bm, cm] + ([] if init_state is None
                                     else [init_state])
    if all(t.device.type == "cpu" for t in tensors):
        y, final = ssd_scan_plain(xh, dt, a, bm, cm, chunk, init_state)
        return (y, final) if return_final_state else y

    b, s, nh, hd = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    if g != 1:
        raise ValueError(f"ssd_scan: the CUDA kernel takes n_groups == 1, "
                         f"got {g}")
    if any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("ssd_scan: dt, a, bm, cm and init_state must be "
                        "float32")
    _build.check_cuda("ssd_scan", *tensors)
    if xh.data_ptr() % 4:
        raise ValueError("ssd_scan: xh is not 4-byte aligned (the kernel "
                         "loads x rows by 4-byte cp.async)")
    y, final = _SSDScan.apply(xh, dt, a, bm, cm, init_state, chunk)
    return (y, final) if return_final_state else y


class _SSDScan(torch.autograd.Function):
    """K7 as an autograd op: the forward launches the CUDA kernel; the
    backward recomputes ``ssd_scan_plain`` on the saved inputs and
    returns its gradients for xh, dt, a, bm, cm and init_state (the JAX
    package trains through its plain ``_ssd_chunked``). Under ``no_grad``
    it is the bare launch."""

    @staticmethod
    def forward(ctx, xh, dt, a, bm, cm, init_state, chunk):
        b, s, nh, hd = xh.shape
        n = bm.shape[3]
        y = torch.empty_like(xh)
        final = torch.empty((b, nh, hd, n), dtype=torch.float32,
                            device=xh.device)
        workspace = torch.empty(work_floats(b, s, nh, hd, n, chunk),
                                dtype=torch.float32, device=xh.device)
        _build.launch("reconic_ssd_scan", xh.data_ptr(), dt.data_ptr(),
                      a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                      None if init_state is None else init_state.data_ptr(),
                      y.data_ptr(), final.data_ptr(), workspace.data_ptr(),
                      workspace.numel(), b, nh, s, hd, n, chunk,
                      int(xh.dtype == torch.bfloat16),
                      _build.stream_ptr(xh.device))
        ssd_scan.launches += 1
        ctx.save_for_backward(xh, dt, a, bm, cm, init_state)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, grad_y, grad_final):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_()
                  for t in saved]
        wrt = [t for t in inputs if t is not None]
        with torch.enable_grad():
            y, final = ssd_scan_plain(*inputs[:5], ctx.chunk, inputs[5])
            grads = iter(torch.autograd.grad((y, final), wrt,
                                             (grad_y, grad_final)))
        return (*[None if t is None else next(grads) for t in inputs],
                None)


ssd_scan.launches = 0
