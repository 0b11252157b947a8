"""Render parameters as plain Python values.

Counterpart of ``ipu_path_trace_tpu/render/params.py`` with the same
field names and defaults.  PyTorch runs eagerly, so the split between
"static" and "traced" fields only survives as documentation; the
reference's XLA-path fields (``use_pallas=False``, ``pallas_interpret``)
are refused by ``render.wavefront.render_step`` when set.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class StaticConfig(NamedTuple):
    """Per-render configuration (shapes, loop bounds, kernel choice)."""

    width: int = 256
    height: int = 256
    max_path_length: int = 10
    aa_noise_type: str = "normal"
    use_pallas: bool = True  # the port always runs its kernels
    use_fused_step: bool = True  # megastep kernel; off = trace + env shade per sample
    pallas_interpret: int = 0  # the port passes host noise explicitly instead
    megastep_stub: str = ""  # "nif" | "trace" | "both": the megastep's measurement stubs
    adaptive_min: int = 8  # adaptive sampling: per-block budget floor (render/adaptive.py)
    adaptive_max_factor: float = 16.0  # budget cap = factor * samples_per_step
    sampler: str = "prng"  # "prng" (Philox) or "sobol" (render/qmc.py prefix)
    sobol_dims: int = 12  # leading dims on the Sobol sequence (camera 4 + 4 per bounce)


def _f32(x) -> float:
    """Round to float32 so every consumer sees the reference's values."""
    return float(np.float32(x))


class RenderSettings(NamedTuple):
    """Runtime-tunable scalars, already rounded to float32."""

    fov: float  # horizontal field of view, radians
    aa_scale: float  # anti-alias jitter scale, pixels
    azimuth: float  # env-map rotation, radians
    refractive_index: float
    stop_prob: float  # russian roulette stop probability
    roulette_depth: int  # bounces before roulette starts
    samples_per_step: int
    aperture: float  # thin-lens radius; 0 = pinhole
    focal_distance: float  # focus-plane distance along -z
    sobol_key: int = 0  # uint32 Owen-Sobol scramble key (--sampler sobol)

    @staticmethod
    def make(
        fov_degrees: float = 90.0,
        aa_scale: float = 0.3,
        env_rotation_degrees: float = 0.0,
        refractive_index: float = 1.5,
        stop_prob: float = 0.3,
        roulette_depth: int = 3,
        samples_per_step: int = 512,
        aperture: float = 0.0,
        focal_distance: float = 1.0,
        seed: int = 1,
    ) -> "RenderSettings":
        return RenderSettings(
            fov=_f32(np.deg2rad(fov_degrees)),
            aa_scale=_f32(aa_scale),
            azimuth=_f32(np.deg2rad(env_rotation_degrees)),
            refractive_index=_f32(refractive_index),
            stop_prob=_f32(stop_prob),
            roulette_depth=int(roulette_depth),
            samples_per_step=int(samples_per_step),
            aperture=_f32(aperture),
            focal_distance=_f32(focal_distance),
            sobol_key=int(seed) & 0xFFFFFFFF,
        )
