"""Hand-written CUDA kernels (sources in ../csrc) and their wrappers; each
wrapper module also holds the kernel's plain PyTorch version."""
