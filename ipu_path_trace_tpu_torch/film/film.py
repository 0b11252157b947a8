"""HDR film accumulation and tone mapping (numpy).

Copy of ``ipu_path_trace_tpu/film/film.py`` without the native runtime:
  hdr[v, u] += rgb / sampleCount        per step
  save: hdr / step
  tone map: (x * 2^exposure)^(1/gamma) -> 8 bit
"""

from __future__ import annotations

import numpy as np

from ..core.records import TRACE_RECORD_DTYPE


def tone_map(hdr: np.ndarray, step: int, exposure: float, gamma: float) -> np.ndarray:
    """HDR (H, W, 3) float32 -> LDR uint8."""
    scaled = hdr * (1.0 / max(step, 1))
    with np.errstate(invalid="ignore"):
        ldr = np.power(np.maximum(scaled * 2.0 ** exposure, 0.0), 1.0 / gamma)
    return np.clip(np.rint(ldr * 255.0), 0.0, 255.0).astype(np.uint8)


class Film:
    """Progressive HDR accumulator over render steps."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.hdr = np.zeros((height, width, 3), np.float32)

    def reset(self) -> None:
        """Zero the film (the device film rebuilds it from the running
        sums at every fetch)."""
        self.hdr[:] = 0.0

    def accumulate(self, records: np.ndarray) -> None:
        """Add one step's trace records: each adds rgb / sampleCount;
        padding records (0xFFFF coords) and empty records are skipped."""
        if records.dtype != TRACE_RECORD_DTYPE:
            raise TypeError(f"expected TRACE_RECORD_DTYPE records, got {records.dtype}")
        self.accumulate_soa(records["u"], records["v"], records["r"], records["g"],
                            records["b"], records["sampleCount"])

    def accumulate_soa(self, u, v, r, g, b, sample_count) -> None:
        """Same as accumulate() from SoA arrays with full-width counts."""
        u = np.asarray(u).astype(np.int64)
        v = np.asarray(v).astype(np.int64)
        cnt = np.asarray(sample_count).astype(np.int64)
        ok = (u >= 0) & (u < self.width) & (v >= 0) & (v < self.height) & (cnt > 0)
        scale = np.zeros(len(u), np.float32)
        np.divide(1.0, cnt, out=scale, where=cnt > 0)
        rgb = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], axis=-1) * scale[:, None]
        np.add.at(self.hdr, (v[ok], u[ok]), rgb[ok])

    def hdr_at_step(self, step: int) -> np.ndarray:
        """The physically normalised HDR image: accumulated / step."""
        return self.hdr * (1.0 / max(step, 1))

    def ldr(self, step: int, exposure: float, gamma: float) -> np.ndarray:
        return tone_map(self.hdr, step, exposure, gamma)
