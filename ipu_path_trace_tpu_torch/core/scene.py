"""Scene description as a NamedTuple of SoA tensors.

Counterpart of ``ipu_path_trace_tpu/core/scene.py``, with identical
values: S spheres followed by D discs, per-object colour, emission,
emissive flag and material.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch


class Material(enum.IntEnum):
    """Material types of ``light::Material::Type``."""

    DIFFUSE = 0
    SPECULAR = 1
    REFRACTIVE = 2


class Scene(NamedTuple):
    """SoA scene: S spheres followed by D discs (N = S + D objects)."""

    sphere_center: torch.Tensor  # (S, 3) f32
    sphere_radius: torch.Tensor  # (S,)
    disc_normal: torch.Tensor  # (D, 3) unit normals
    disc_center: torch.Tensor  # (D, 3)
    disc_radius: torch.Tensor  # (D,)
    colour: torch.Tensor  # (N, 3)
    emission: torch.Tensor  # (N, 3)
    emissive: torch.Tensor  # (N,) bool
    material: torch.Tensor  # (N,) int32 (Material)

    @property
    def num_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def num_discs(self) -> int:
        return self.disc_radius.shape[0]

    @property
    def num_objects(self) -> int:
        return self.colour.shape[0]

    def to(self, device) -> "Scene":
        return Scene(*(t.to(device) for t in self))


def make_scene(spheres, discs, colours, emissions, materials, *, device="cpu") -> Scene:
    """Build a Scene from python lists (same arguments as the reference).

    spheres:   [(center_xyz, radius), ...]
    discs:     [(normal_xyz, center_xyz, radius), ...]
    colours / emissions / materials: per object, spheres then discs.
    """
    n = len(spheres) + len(discs)
    if not (len(colours) == len(emissions) == len(materials) == n):
        raise ValueError("Per-object attribute counts must match object count.")
    f32 = np.float32
    sphere_center = np.array([c for c, _ in spheres], f32).reshape(len(spheres), 3)
    sphere_radius = np.array([r for _, r in spheres], f32)
    disc_normal = np.array([n_ for n_, _, _ in discs], f32).reshape(len(discs), 3)
    disc_center = np.array([c for _, c, _ in discs], f32).reshape(len(discs), 3)
    disc_radius = np.array([r for _, _, r in discs], f32)
    if len(discs):
        disc_normal = disc_normal / np.linalg.norm(disc_normal, axis=1, keepdims=True)
    emission = np.array(emissions, f32).reshape(n, 3)
    arrays = (
        sphere_center,
        sphere_radius,
        disc_normal,
        disc_center,
        disc_radius,
        np.array(colours, f32).reshape(n, 3),
        emission,
        np.any(emission != 0.0, axis=1),
        np.array([int(m) for m in materials], np.int32),
    )
    return Scene(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays))


def grid_scene(num_spheres: int, emissive_every: int = 8, device="cpu") -> Scene:
    """Procedural stress scene: ``num_spheres`` spheres on a grid + floor.

    For measuring how the trace scales with object count: spheres on an
    approximately square XZ grid in front of the default camera, cycling
    diffuse / specular / refractive materials; every ``emissive_every``-th
    sphere is a small light.  Deterministic - no RNG.
    """
    if num_spheres < 1:
        raise ValueError("num_spheres must be >= 1")
    cols = max(1, int(np.ceil(np.sqrt(num_spheres))))
    rows = int(np.ceil(num_spheres / cols))
    spacing = 1.1
    radius = 0.42
    spheres, colours, emissions, materials = [], [], [], []
    M = Material
    mats = [M.DIFFUSE, M.SPECULAR, M.REFRACTIVE]
    palette = [(1.6, 0.7, 0.5), (1.0, 1.0, 1.0), (0.75, 0.75, 0.75),
               (0.5, 1.2, 0.8), (1.4, 1.4, 0.6)]
    for i in range(num_spheres):
        r, c = divmod(i, cols)
        x = (c - (cols - 1) / 2.0) * spacing
        z = -3.0 - r * spacing
        y = -1.6 + radius + 0.25 * ((i * 7) % 3)
        spheres.append(((x, y, z), radius))
        if emissive_every and i % emissive_every == emissive_every - 1:
            colours.append((1.0, 1.0, 1.0))
            emissions.append((10.0, 9.5, 8.0))
            materials.append(M.DIFFUSE)
        else:
            colours.append(palette[i % len(palette)])
            emissions.append((0.0, 0.0, 0.0))
            materials.append(mats[i % len(mats)])
    discs = [((0.0, 1.0, 0.0), (0.0, -1.6, -3.0 - (rows - 1) * spacing / 2.0),
              2.0 + max(cols, rows) * spacing)]
    colours.append((1.5, 1.5, 1.4))
    emissions.append((0.0, 0.0, 0.0))
    materials.append(M.DIFFUSE)
    return make_scene(spheres, discs, colours, emissions, materials, device=device)


def default_scene(device="cpu") -> Scene:
    """The reference's hard-coded scene: five spheres (left diffuse,
    middle mirror, right glass, front diffuse with a refractive
    clear-coat shell) over a diffuse floor disc, colour gain 2x baked in."""
    gain = 2.0
    sphere_colour = (1.0 * gain, 0.89 * gain, 0.55 * gain)
    clear_coat_colour = (0.8 * gain, 0.06 * gain, 0.391 * gain)
    floor_colour = (0.98 * gain, 0.76 * gain, 0.66 * gain)
    glass_tint = (0.75, 0.75, 0.75)
    one = (1.0, 1.0, 1.0)
    zero = (0.0, 0.0, 0.0)
    M = Material
    return make_scene(
        spheres=[
            ((-1.8575, -0.98714, -3.6), 0.6),  # left
            ((0.74795, -0.55, -4.3816), 1.05),  # middle
            ((1.9929, -1.08666, -3.23), 0.5),  # right
            ((-0.19931, -1.183, -2.75), 0.4),  # front diffuse part
            ((-0.19931, -1.183, -2.75), 0.4001),  # front clear-coat part
        ],
        discs=[((0.0, 1.0, 0.0), (0.0, -1.6, -5.22), 3.5)],  # floor
        colours=[sphere_colour, one, glass_tint, clear_coat_colour, one, floor_colour],
        emissions=[zero, zero, zero, zero, zero, zero],
        materials=[M.DIFFUSE, M.SPECULAR, M.REFRACTIVE, M.DIFFUSE, M.REFRACTIVE, M.DIFFUSE],
        device=device,
    )
