# Hand-written CUDA kernels for Hopper (csrc/), each beside its plain
# PyTorch version; ops.py and lc_offload.py are the callers.
