"""The port's kernels: each module holds one CUDA kernel's wrapper (with
its launch counter) and the kernel's plain PyTorch version."""
