"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Kernels are built from ``csrc/`` at first use (``build``)."""
