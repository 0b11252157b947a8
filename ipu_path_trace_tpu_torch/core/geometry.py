"""Ray/scene intersection over a batch of rays (plain PyTorch).

Counterpart of ``ipu_path_trace_tpu/core/geometry.py``: the same
smallpaint-lineage math (sphere quadratic keeping the nearest root
> EPS; disc = plane hit plus radius check) and the same select-chain
winner order (spheres, then discs).  The CUDA trace kernel
(``csrc/common.cuh::intersect``) mirrors this function ray by ray.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .scene import Scene
from .vecmath import Vec3

# Self-intersection epsilon; must equal the reference's EPS and
# cpu/oracle._EPS (3x below the clear-coat shell gap of 1e-4).
EPS = 3e-5
_INF = float("inf")


class Hit(NamedTuple):
    """Per-lane intersection result (SoA over the ray batch)."""

    valid: torch.Tensor  # bool
    t: torch.Tensor  # distance (inf on a miss)
    point: Vec3  # hit position: the next ray origin
    normal: Vec3
    obj: torch.Tensor  # int32 object index (spheres then discs)
    colour: Vec3
    emission: Vec3
    emissive: torch.Tensor  # bool
    material: torch.Tensor  # int32 Material


def _sphere_t(cx, cy, cz, radius, o: Vec3, d: Vec3) -> torch.Tensor:
    """Hit distance for one sphere over the ray batch (inf = miss)."""
    ox = o.x - cx
    oy = o.y - cy
    oz = o.z - cz
    b = 2.0 * (ox * d.x + oy * d.y + oz * d.z)
    c = ox * ox + oy * oy + oz * oz - radius * radius
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    near = (-b - sq) * 0.5
    far = (-b + sq) * 0.5
    inf = torch.full_like(near, _INF)
    t = torch.where(near > EPS, near, torch.where(far > EPS, far, inf))
    return torch.where(disc >= 0.0, t, inf)


def _disc_t(nx, ny, nz, cx, cy, cz, radius, o: Vec3, d: Vec3) -> torch.Tensor:
    """Hit distance for one disc over the ray batch (inf = miss)."""
    denom = d.x * nx + d.y * ny + d.z * nz
    num = (cx - o.x) * nx + (cy - o.y) * ny + (cz - o.z) * nz
    ok_denom = torch.abs(denom) > 1e-12
    t = num / torch.where(ok_denom, denom, torch.full_like(denom, 1e-12))
    px = o.x + d.x * t - cx
    py = o.y + d.y * t - cy
    pz = o.z + d.z * t - cz
    inside = px * px + py * py + pz * pz <= radius * radius
    ok = (t > EPS) & inside & ok_denom
    return torch.where(ok, t, torch.full_like(t, _INF))


def intersect_scene(scene: Scene, o: Vec3, d: Vec3) -> Hit:
    """Nearest hit of each ray with every object (``d`` normalised).

    ``point`` is the ray advanced to the hit, the next bounce's origin.
    """
    num_s = scene.num_spheres
    shape = o.x.shape
    dev = o.x.device
    best_t = torch.full(shape, _INF, device=dev)
    best_obj = torch.zeros(shape, dtype=torch.int32, device=dev)
    nrm = Vec3.zeros(shape, device=dev)
    colour = Vec3.zeros(shape, device=dev)
    emission = Vec3.zeros(shape, device=dev)
    emissive = torch.zeros(shape, dtype=torch.bool, device=dev)
    material = torch.zeros(shape, dtype=torch.int32, device=dev)
    win_c = Vec3.zeros(shape, device=dev)
    won_sphere = torch.zeros(shape, dtype=torch.bool, device=dev)

    def take(k, t_k):
        nonlocal best_t, best_obj, colour, emission, emissive, material
        closer = t_k < best_t
        best_t = torch.where(closer, t_k, best_t)
        best_obj = torch.where(closer, torch.full_like(best_obj, k), best_obj)
        colour = Vec3(*(torch.where(closer, scene.colour[k, i], c)
                        for i, c in enumerate(colour)))
        emission = Vec3(*(torch.where(closer, scene.emission[k, i], e)
                          for i, e in enumerate(emission)))
        emissive = torch.where(closer, scene.emissive[k], emissive)
        material = torch.where(closer, scene.material[k], material)
        return closer

    for k in range(num_s):
        cx, cy, cz = scene.sphere_center[k]
        closer = take(k, _sphere_t(cx, cy, cz, scene.sphere_radius[k], o, d))
        win_c = Vec3(torch.where(closer, cx, win_c.x),
                     torch.where(closer, cy, win_c.y),
                     torch.where(closer, cz, win_c.z))
        won_sphere = won_sphere | closer

    for j in range(scene.num_discs):
        nx, ny, nz = scene.disc_normal[j]
        cx, cy, cz = scene.disc_center[j]
        closer = take(num_s + j,
                      _disc_t(nx, ny, nz, cx, cy, cz, scene.disc_radius[j], o, d))
        nrm = Vec3(torch.where(closer, nx, nrm.x),
                   torch.where(closer, ny, nrm.y),
                   torch.where(closer, nz, nrm.z))
        won_sphere = won_sphere & ~closer

    valid = torch.isfinite(best_t)
    t_safe = torch.where(valid, best_t, torch.zeros_like(best_t))
    point = Vec3(o.x + d.x * t_safe, o.y + d.y * t_safe, o.z + d.z * t_safe)
    if num_s:
        n_s = point - win_c
        inv = 1.0 / torch.sqrt(torch.clamp_min(n_s.norm2(), 1e-20))
        nrm = (n_s * inv).where(won_sphere, nrm)
    return Hit(valid=valid, t=best_t, point=point, normal=nrm, obj=best_obj,
               colour=colour, emission=emission, emissive=emissive,
               material=material)
