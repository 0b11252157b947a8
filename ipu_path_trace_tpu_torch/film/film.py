"""HDR film accumulation and tone mapping.

Counterpart of ``ipu_path_trace_tpu/film/film.py``:
  hdr[v, u] += rgb / sampleCount        per step
  save: hdr / step
  tone map: (x * 2^exposure)^(1/gamma) -> 8 bit

A ``Film`` runs the native host runtime (runtime/native.py, C++ with
OpenMP) unless it is made with ``native=False``, which runs the plain
NumPy versions below.  The two give the same HDR bit for bit; the native
tone map rounds half up (the reference's cv::convertTo) where ``np.rint``
rounds half to even, so an LDR value may differ by 1.
"""

from __future__ import annotations

import numpy as np

from ..core.records import TRACE_RECORD_DTYPE
from ..runtime import native as _native


def tone_map_plain(scaled: np.ndarray, exposure: float, gamma: float) -> np.ndarray:
    """Plain version of the native tone map, on an already normalised HDR."""
    tone_map_plain.calls += 1
    with np.errstate(invalid="ignore"):
        ldr = np.power(np.maximum(scaled * 2.0 ** exposure, 0.0), 1.0 / gamma)
    return np.clip(np.rint(ldr * 255.0), 0.0, 255.0).astype(np.uint8)


tone_map_plain.calls = 0


def accumulate_plain(hdr: np.ndarray, u, v, r, g, b, sample_count) -> None:
    """Plain version of the native accumulation: hdr[v, u] += rgb / count
    for every record inside the image with a non-zero count, in float32
    as the native route reads the sums."""
    accumulate_plain.calls += 1
    height, width = hdr.shape[:2]
    u = np.asarray(u).astype(np.int64)
    v = np.asarray(v).astype(np.int64)
    cnt = np.asarray(sample_count).astype(np.int64)
    ok = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (cnt > 0)
    scale = np.zeros(len(u), np.float32)
    np.divide(1.0, cnt, out=scale, where=cnt > 0)
    rgb = np.stack([np.asarray(c, np.float32) for c in (r, g, b)], axis=-1) * scale[:, None]
    np.add.at(hdr, (v[ok], u[ok]), rgb[ok])


accumulate_plain.calls = 0


def tone_map(hdr: np.ndarray, step: int, exposure: float, gamma: float,
             native: bool = True) -> np.ndarray:
    """HDR (H, W, 3) float32 accumulated over ``step`` steps -> LDR uint8."""
    scaled = hdr * (1.0 / max(step, 1))
    if native:
        return _native.tonemap(scaled, exposure, gamma)
    return tone_map_plain(scaled, exposure, gamma)


class Film:
    """Progressive HDR accumulator over render steps."""

    def __init__(self, width: int, height: int, native: bool = True):
        self.width = width
        self.height = height
        self.native = native
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
        if self.native:
            _native.accumulate(records, self.hdr)
        else:
            accumulate_plain(self.hdr, records["u"], records["v"], records["r"], records["g"],
                             records["b"], records["sampleCount"])

    def accumulate_soa(self, u, v, r, g, b, sample_count) -> None:
        """Same as accumulate() from SoA arrays with full-width counts."""
        if self.native:
            _native.accumulate_soa(u, v, r, g, b, sample_count, self.hdr)
        else:
            accumulate_plain(self.hdr, u, v, r, g, b, sample_count)

    def hdr_at_step(self, step: int) -> np.ndarray:
        """The physically normalised HDR image: accumulated / step."""
        return self.hdr * (1.0 / max(step, 1))

    def ldr(self, step: int, exposure: float, gamma: float) -> np.ndarray:
        return tone_map(self.hdr, step, exposure, gamma, self.native)
