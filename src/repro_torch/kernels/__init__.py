"""Hand-written Hopper kernels (CUDA C++ sources under ``csrc/``), each
beside its plain PyTorch version and a launch count (``backend``)."""
