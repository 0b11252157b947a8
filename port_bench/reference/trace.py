"""The plain reference's path trace: Philox noise, camera, bounce loop.

A frozen copy of the renderer's plain trace, batched over (record,
sample) lanes: the noise of sample s of worklist record p under the two
seed words (k0, k1) is Philox4x32-10 at counter (p, s, group, 0), four
24-bit uniforms a group; group 0 gives the anti-aliasing jitter (Box-
Muller) and the lens pair, group 1 + b bounce b's roulette, two
direction uniforms and the Fresnel choice.  The arithmetic is the
renderer's operation for operation (its kernels are built to replay it).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .geometry import (DIFFUSE_SCALE, REFRACT_WEIGHT, Material, Scene, Vec3, intersect_scene,
                       pixel_to_ray, reflect, refract, sample_diffuse)

MASK32 = 0xFFFFFFFF
FOLD_TAG = 0x6D657368  # counter word 1 of a mesh shard's seed fold ("mesh")


def _f32(x) -> float:
    return float(np.float32(x))


class Settings(NamedTuple):
    """The render's scalars, rounded to float32 as the renderer rounds them."""

    fov: float  # radians
    aa_scale: float
    azimuth: float  # radians
    refractive_index: float
    stop_prob: float
    roulette_depth: int
    width: int
    height: int
    max_path_length: int
    aa_noise_type: str

    @staticmethod
    def make(width: int, height: int, *, fov_degrees=90.0, aa_scale=0.3, env_rotation_degrees=0.0,
             refractive_index=1.5, stop_prob=0.3, roulette_depth=3, max_path_length=10,
             aa_noise_type="normal") -> "Settings":
        return Settings(_f32(np.deg2rad(fov_degrees)), _f32(aa_scale),
                        _f32(np.deg2rad(env_rotation_degrees)), _f32(refractive_index),
                        _f32(stop_prob), int(roulette_depth), int(width), int(height),
                        int(max_path_length), aa_noise_type)


# ----------------------------------------------------------------- Philox ----

def _mulhilo32(a: int, b):
    hp = a * (b >> 16)
    lp = a * (b & 0xFFFF)
    s = lp + ((hp & 0xFFFF) << 16)
    return (hp >> 16) + (s >> 32), s & MASK32


def philox4x32_10(c: list, k0: int, k1: int) -> list:
    """Philox4x32-10 on int64 tensors (or Python ints) holding uint32 words."""
    x0, x1, x2, x3 = c
    for _ in range(10):
        hi0, lo0 = _mulhilo32(0xD2511F53, x0)
        hi1, lo1 = _mulhilo32(0xCD9E8D57, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & MASK32
        k1 = (k1 + 0xBB67AE85) & MASK32
    return [x0, x1, x2, x3]


def step_seeds(seed: int, steps: int) -> list[tuple[int, int]]:
    """The two kernel seed words of each of a render's steps: a CPU
    ``torch.Generator`` seeded with the render seed, two uint32 draws a step."""
    gen = torch.Generator().manual_seed(seed)
    return [tuple(int(x) for x in torch.randint(0, 1 << 32, (2,), generator=gen))
            for _ in range(steps)]


def fold_seed(seed: tuple[int, int], index: int) -> tuple[int, int]:
    words = philox4x32_10([int(index) & MASK32, FOLD_TAG, 0, 0], int(seed[0]) & MASK32,
                          int(seed[1]) & MASK32)
    return int(words[0]), int(words[1])


def shard_seed(seed: tuple[int, int], i: int, j: int) -> tuple[int, int]:
    """The seed words of mesh shard (pixel i, sample replica j)."""
    return fold_seed(fold_seed(seed, i), j)


def _u24(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 8) + 1).to(torch.float32) * (1.0 / (1 << 24))


def aa_jitter(u1: torch.Tensor, u2: torch.Tensor, aa_noise_type: str):
    if aa_noise_type == "uniform":
        return 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    two_pi = 2.0 * math.pi
    r = torch.sqrt(-2.0 * torch.log(u1))
    z1 = r * torch.cos(two_pi * u2)
    z2 = r * torch.sin(two_pi * u2)
    if aa_noise_type == "truncated-normal":
        z1, z2 = torch.clamp(z1, -3.0, 3.0), torch.clamp(z2, -3.0, 3.0)
    return z1, z2


def noise_rows(seed: tuple[int, int], lane: torch.Tensor, sample: torch.Tensor,
               max_path_length: int, aa_noise_type: str) -> torch.Tensor:
    """(4 + 4L, n) uniforms of the lanes' (record, sample) pairs."""
    zero = torch.zeros_like(lane)
    k0, k1 = int(seed[0]) & MASK32, int(seed[1]) & MASK32
    rows = []
    for g in range(1 + max_path_length):
        rows.extend(_u24(w) for w in philox4x32_10([lane, sample & MASK32, zero + g, zero],
                                                   k0, k1))
    rows[0], rows[1] = aa_jitter(rows[0], rows[1], aa_noise_type)
    return torch.stack(rows)


# ------------------------------------------------------------------ trace ----

class PathOut(NamedTuple):
    radiance: Vec3  # emission gathered along the path
    esc_dir: Vec3  # the escaping direction (zero where none)
    esc_w: Vec3  # the throughput at the escape (zero where none)
    escaped: torch.Tensor
    path_len: torch.Tensor  # int32


def trace_paths(scene: Scene, st: Settings, cols: torch.Tensor, rows: torch.Tensor,
                noise: torch.Tensor) -> PathOut:
    """One path per lane of a pinhole camera from fractional pixel
    coordinates and (4 + 4L, n) noise rows (rows 2-3, the lens pair, are
    not read)."""
    dev = cols.device
    f32 = dict(dtype=torch.float32, device=dev)
    n = cols.shape[0]
    c = cols + st.aa_scale * noise[0]
    r = rows + st.aa_scale * noise[1]
    d = pixel_to_ray(c, r, st.width, st.height, st.fov).normalized()
    zero = torch.zeros_like(c)
    o = Vec3(zero, zero, zero)
    z = Vec3.zeros((n,), device=dev)
    throughput = Vec3.full((n,), 1.0, 1.0, 1.0, device=dev)
    radiance, esc_dir, esc_w = z, z, z
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    escaped = torch.zeros(n, dtype=torch.bool, device=dev)
    path_len = torch.zeros(n, dtype=torch.int32, device=dev)
    stop_prob = torch.tensor(st.stop_prob, **f32)
    refr_index = torch.tensor(st.refractive_index, **f32)
    one = Vec3.full((n,), 1.0, 1.0, 1.0, device=dev)
    for i in range(st.max_path_length):
        rnd = noise[4 + 4 * i:8 + 4 * i]
        rr_rand, u1, u2, fresnel_rand = rnd[0], rnd[1], rnd[2], rnd[3]
        rr_on = i >= st.roulette_depth
        rr_factor = 1.0 / (1.0 - stop_prob) if rr_on else torch.tensor(1.0, **f32)
        if rr_on:
            alive = alive & ~(rr_rand <= stop_prob)
        hit = intersect_scene(scene, o, d)
        escaped_now = alive & ~hit.valid
        esc_dir = d.where(escaped_now, esc_dir)
        esc_w = (throughput * rr_factor).where(escaped_now, esc_w)
        escaped = escaped | escaped_now
        emit_now = alive & hit.valid & hit.emissive
        radiance = (radiance + throughput.cwise(hit.emission) * rr_factor).where(emit_now,
                                                                               radiance)
        alive = alive & hit.valid & ~hit.emissive
        d_diff, cos_theta = sample_diffuse(hit.normal, u1, u2)
        d_spec = reflect(d, hit.normal)
        d_refr, refracted = refract(d, hit.normal, refr_index, fresnel_rand)
        is_diff = hit.material == int(Material.DIFFUSE)
        is_spec = hit.material == int(Material.SPECULAR)
        new_d = d_diff.where(is_diff, d_spec.where(is_spec, d_refr))
        w_diff = hit.colour * (cos_theta * DIFFUSE_SCALE * rr_factor)
        w_spec = one * rr_factor
        w_refr = hit.colour.where(refracted, one) * (REFRACT_WEIGHT * rr_factor)
        scale = w_diff.where(is_diff, w_spec.where(is_spec, w_refr))
        pushed = escaped_now | emit_now | alive
        o = hit.point.where(alive, o)
        d = new_d.where(alive, d)
        throughput = throughput.cwise(scale).where(alive, throughput)
        path_len = path_len + pushed.to(torch.int32)
    return PathOut(radiance, esc_dir, esc_w, escaped, path_len)


def escape_share(scene: Scene, st: Settings, seed: int, stride: int, samples: int,
                 device="cpu") -> float:
    """The share of camera paths that escape (and so need one NIF
    evaluation): every ``stride``-th pixel of the raster, ``samples``
    samples each under the first step's seed words of ``seed``."""
    px = torch.arange(0, st.width * st.height, stride, dtype=torch.int64, device=device)
    cols = (px % st.width).to(torch.float32)
    rows = (px // st.width).to(torch.float32)
    key = step_seeds(seed, 1)[0]
    hits = 0
    for s in range(samples):
        noise = noise_rows(key, px, torch.full_like(px, s), st.max_path_length, st.aa_noise_type)
        hits += int(trace_paths(scene, st, cols, rows, noise).escaped.sum())
    return hits / (samples * px.numel())
