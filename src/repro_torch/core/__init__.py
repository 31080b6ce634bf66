# The RecoNIC system on PyTorch: the RDMA engine, its transport and
# the Lookaside Compute block.
