"""Pinhole camera and anti-aliasing jitter (plain PyTorch).

Counterpart of ``ipu_path_trace_tpu/core/camera.py``.  The horizontal
field of view (radians) maps the width onto tan(fov/2); the vertical
scale uses tan((h/w) * fov/2).  Noise comes from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

from .vecmath import Vec3

AA_NOISE_TYPES = ("uniform", "normal", "truncated-normal")


def pixel_to_ray(col: torch.Tensor, row: torch.Tensor, width: int, height: int,
                 fov: float) -> Vec3:
    """Fractional pixel coords -> unnormalised camera ray (x, y, -1)."""
    dev = col.device
    w = torch.tensor(float(width), device=dev)
    h = torch.tensor(float(height), device=dev)
    half_fov = torch.tensor(fov, dtype=torch.float32, device=dev) * 0.5
    x = ((2.0 * col - w) / w) * torch.tan(half_fov)
    y = -((2.0 * row - h) / h) * torch.tan((h / w) * half_fov)
    return Vec3(x, y, torch.full_like(x, -1.0))


_ALPHA = 3.0  # truncated-normal bound (poprand::truncatedNormal alpha)


def aa_noise(gen: torch.Generator, shape, noise_type: str = "normal",
             device="cpu") -> torch.Tensor:
    """Anti-aliasing jitter in pixel units drawn from ``gen``.

    uniform: U[-1, 1); normal: N(0, 1); truncated-normal: N(0, 1)
    truncated at +/- 3 sigma by an exact inverse CDF.
    """
    if noise_type == "uniform":
        return torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0
    if noise_type == "normal":
        return torch.randn(shape, generator=gen, device=device)
    if noise_type == "truncated-normal":
        lo = 0.5 * (1.0 + math.erf(-_ALPHA / math.sqrt(2.0)))
        u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=gen, device=device)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        return torch.clamp(z, -_ALPHA, _ALPHA)
    raise ValueError(f"Invalid AA noise type: {noise_type!r} (expected one of {AA_NOISE_TYPES})")
