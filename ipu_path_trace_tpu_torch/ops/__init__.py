"""The port's kernels: each module holds its CUDA kernels' wrappers (each
with its launch counter) and the kernels' plain PyTorch versions."""
