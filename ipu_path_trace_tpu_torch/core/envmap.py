"""Equirectangular environment-map projection (plain PyTorch).

Counterpart of ``ipu_path_trace_tpu/core/envmap.py``, with the true
acos/atan2 (the CUDA env-shade kernel uses acosf/atan2f likewise).
"""

from __future__ import annotations

import math

import torch

from .vecmath import Vec3

PI = math.pi
TWO_PI = 2.0 * math.pi


def equirect_uv(direction: Vec3, azimuth_offset: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit directions -> equirect (u, v) in [0, 1].

    theta = acos(y); phi = atan2(z, x) + azimuth wrapped into [0, 2 pi]
    with a single add/subtract; u = theta / pi, v = phi / 2 pi.
    """
    y = torch.clamp(direction.y, -1.0, 1.0)
    theta = torch.arccos(y)
    phi = torch.atan2(direction.z, direction.x) + torch.tensor(
        azimuth_offset, dtype=torch.float32, device=y.device)
    phi = torch.where(phi < 0.0, phi + TWO_PI,
                      torch.where(phi > TWO_PI, phi - TWO_PI, phi))
    return theta * (1.0 / PI), phi * (1.0 / TWO_PI)
