"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each with its
plain PyTorch version beside it: ``condense_qp`` (K1), ``admm`` (K2) and
``astar`` (K3)."""
