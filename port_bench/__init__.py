"""The benchmark of the PyTorch and CUDA renderer (``ipu_path_trace_tpu_torch``).

``run.py`` runs one cell of BENCHMARK.json; README.md says how cells,
configurations, traffic mixes and per-layer metrics are added as files.
"""
