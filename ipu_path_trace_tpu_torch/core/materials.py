"""BSDF sampling over masked lanes (plain PyTorch).

Counterpart of ``ipu_path_trace_tpu/core/materials.py`` (smallpaint
lineage).  Throughput semantics, applied forwards:
  DIFFUSE   throughput *= colour * (cos_theta * 0.1 * rrFactor)
  SPECULAR  throughput *= rrFactor
  REFRACT   throughput *= tint * (1.15 * rrFactor)
"""

from __future__ import annotations

import math

import torch

from .vecmath import Vec3, orthonormal_basis

DIFFUSE_SCALE = 0.1  # smallpaint's diffuse albedo scale
REFRACT_WEIGHT = 1.15  # smallpaint's refraction boost
TWO_PI = 2.0 * math.pi


def roulette_weight(rand, stop_prob):
    """Russian roulette: (stop, weight) = light::rouletteWeight(rand, p).
    Stops when rand <= p; a surviving ray is compensated by 1 / (1 - p).
    The kernels do the roulette inside (csrc/common.cuh); this is the
    helper the reference exposes."""
    stop = rand <= stop_prob
    weight = 1.0 / (1.0 - stop_prob)
    return stop, weight


def hemisphere_sample(u1: torch.Tensor, u2: torch.Tensor) -> Vec3:
    """Uniform hemisphere sample about +z: z = u1, azimuth 2 pi u2."""
    r = torch.sqrt(torch.clamp_min(1.0 - u1 * u1, 0.0))
    phi = TWO_PI * u2
    return Vec3(torch.cos(phi) * r, torch.sin(phi) * r, u1)


def sample_diffuse(normal: Vec3, u1, u2) -> tuple[Vec3, torch.Tensor]:
    """New direction for a diffuse bounce; returns (direction, cos_theta)."""
    t1, t2 = orthonormal_basis(normal)
    s = hemisphere_sample(u1, u2)
    d = t1 * s.x + t2 * s.y + normal * s.z
    return d, d.dot(normal)


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror reflection: d - 2 (d.n) n."""
    return d - n * (2.0 * d.dot(n))


def refract(d: Vec3, n: Vec3, refractive_index, rand) -> tuple[Vec3, torch.Tensor]:
    """Glass interaction with Schlick-approximated Fresnel choice.

    Flips the normal when the ray is inside the medium, refracts when
    cos^2(theta_2) > 0 and rand > R(theta), otherwise reflects.
    Returns (new_dir, refracted).  ``refractive_index`` is an f32 0-d
    tensor, so every derived constant rounds like the reference's.
    """
    n_idx = refractive_index
    r0 = (1.0 - n_idx) / (1.0 + n_idx)
    r0 = r0 * r0
    inside = d.dot(n) > 0.0
    nl = n.where(~inside, -n)
    eta = torch.where(inside, n_idx, 1.0 / n_idx)
    cost1 = -d.dot(nl)
    cost2 = 1.0 - eta * eta * (1.0 - cost1 * cost1)
    p1 = 1.0 - cost1
    p2 = p1 * p1
    rprob = r0 + (1.0 - r0) * (p2 * p2 * p1)
    do_refract = (cost2 > 0.0) & (rand > rprob)
    sqrt_cost2 = torch.sqrt(torch.clamp_min(cost2, 0.0))
    d_refr = (d * eta + nl * (eta * cost1 - sqrt_cost2)).normalized()
    d_refl = (d + nl * (2.0 * cost1)).normalized()
    return d_refr.where(do_refract, d_refl), do_refract
