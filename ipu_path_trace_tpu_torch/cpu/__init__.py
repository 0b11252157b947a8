"""The NumPy oracle: an independent twin of the renderer (cpu/oracle.py)."""

from .oracle import (OracleScene, oracle_scene_from, oracle_streams, render_oracle,
                     trace_sample_oracle)

__all__ = ["OracleScene", "oracle_scene_from", "oracle_streams", "render_oracle",
           "trace_sample_oracle"]
