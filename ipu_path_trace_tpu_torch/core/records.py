"""Trace-record work items: SoA tensors on the device, 20-byte AoS on the host.

Counterpart of ``ipu_path_trace_tpu/core/records.py``.  The host
worklist keeps the reference's exact ``TraceRecord`` layout (u16 u, v;
f32 r, g, b; u16 sampleCount, pathLength); the device side is SoA
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TRACE_RECORD_DTYPE = np.dtype(
    [
        ("u", "<u2"),
        ("v", "<u2"),
        ("r", "<f4"),
        ("g", "<f4"),
        ("b", "<f4"),
        ("sampleCount", "<u2"),
        ("pathLength", "<u2"),
    ]
)
assert TRACE_RECORD_DTYPE.itemsize == 20, "TraceRecord must stay 20 bytes"

DUMMY_COORD = np.uint16(0xFFFF)  # worklist padding marker


class WorkBatch(NamedTuple):
    """Device-side SoA view of a worklist."""

    u: torch.Tensor  # (P,) int32 pixel column (0xFFFF = padding)
    v: torch.Tensor  # (P,) int32 pixel row
    r: torch.Tensor  # (P,) f32 accumulated red
    g: torch.Tensor
    b: torch.Tensor
    sample_count: torch.Tensor  # (P,) int32
    path_length: torch.Tensor  # (P,) int32


def make_worklist(width: int, height: int, padded_size: int | None = None) -> np.ndarray:
    """One record per pixel in row-major order, padded with dummy coords."""
    n = width * height
    padded = n if padded_size is None else padded_size
    if padded < n:
        raise ValueError("padded_size smaller than pixel count")
    wl = np.zeros(padded, TRACE_RECORD_DTYPE)
    cols, rows = np.meshgrid(np.arange(width, dtype=np.uint16),
                             np.arange(height, dtype=np.uint16))
    wl["u"][:n] = cols.ravel()
    wl["v"][:n] = rows.ravel()
    wl["u"][n:] = DUMMY_COORD
    wl["v"][n:] = DUMMY_COORD
    return wl


def to_device_batch(worklist: np.ndarray, device) -> WorkBatch:
    """Unpack a host worklist into SoA tensors on ``device``."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a.astype(dtype))).to(device)

    return WorkBatch(
        u=put(worklist["u"], np.int32),
        v=put(worklist["v"], np.int32),
        r=put(worklist["r"], np.float32),
        g=put(worklist["g"], np.float32),
        b=put(worklist["b"], np.float32),
        sample_count=put(worklist["sampleCount"], np.int32),
        path_length=put(worklist["pathLength"], np.int32),
    )


def from_device_batch(batch: WorkBatch) -> np.ndarray:
    """Pack SoA results back into the 20-byte wire layout (host)."""
    host = WorkBatch(*(t.cpu().numpy() for t in batch))
    wl = np.zeros(host.u.shape[0], TRACE_RECORD_DTYPE)
    wl["u"] = host.u.astype(np.uint16)
    wl["v"] = host.v.astype(np.uint16)
    wl["r"] = host.r
    wl["g"] = host.g
    wl["b"] = host.b
    # sampleCount saturates at the u16 limit; pathLength wraps mod 2^16
    # like the u16 field (README "Known limitations").
    wl["sampleCount"] = np.clip(host.sample_count, 0, 0xFFFF).astype(np.uint16)
    wl["pathLength"] = host.path_length.astype(np.uint16)
    return wl


def raster_permutation(records: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H*W,) int32 map: raster pixel index -> worklist record index.

    The device preview gathers the worklist's running sums into raster
    order with it.  Every real pixel must appear exactly once (the load
    balancer permutes records and never duplicates them); a worklist that
    drops or duplicates a pixel raises instead of mapping the missing
    pixels to record 0.
    """
    if records.dtype != TRACE_RECORD_DTYPE:
        raise TypeError(f"expected TRACE_RECORD_DTYPE records, got {records.dtype}")
    u = records["u"].astype(np.int64)
    v = records["v"].astype(np.int64)
    ok = (u < width) & (v < height)
    idx = v[ok] * width + u[ok]
    counts = np.bincount(idx, minlength=height * width)
    if not (counts == 1).all():
        raise ValueError(f"worklist is not a pixel permutation for {width}x{height}: "
                         f"{int((counts == 0).sum())} missing, "
                         f"{int((counts > 1).sum())} duplicated")
    perm = np.zeros(height * width, np.int64)
    perm[idx] = np.nonzero(ok)[0]
    return perm.astype(np.int32)
