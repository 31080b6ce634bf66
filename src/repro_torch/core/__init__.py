# The RecoNIC system on PyTorch: the RDMA engine, its transport, the
# Lookaside Compute block and the streaming dispatch plane.
