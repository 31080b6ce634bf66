"""repro_torch — the RecoNIC datapath on PyTorch and CUDA (NVIDIA H100).

The PyTorch counterpart of the ``repro`` package: the same module layout,
the same verbs, scheduler, descriptor transport and Lookaside Compute
block, with the registered pool as a tensor on the GPU and the offloaded
kernels as hand-written CUDA kernels (``kernels/csrc``). Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
