"""Hand-written CUDA kernels (built from ``csrc/`` on first use)."""
