"""PyTorch + CUDA port of the ipu_path_trace_tpu renderer.

The JAX package ``ipu_path_trace_tpu`` is the reference; this package
mirrors its sub-package and module names (``core``, ``models``, ``ops``,
``render``, ``film``, ``runtime``) so each counterpart is easy to find.
It imports ``torch`` and never ``jax``.

Every TPU kernel on the ported paths (the render main path in bf16 and
int8, the baked env) has a hand-written CUDA C++ counterpart under
``csrc/`` (built with nvcc for sm_90a at first use) and a plain PyTorch
version beside its wrapper in ``ops/``: a CPU tensor runs the plain
version, a CUDA tensor runs the kernel or raises.
"""
