"""The plain reference's worklist: its size, padding and coherent order.

The renderer pads the image's pixels to 1472 virtual tiles of
ceil(W H / 1472) rays (plus that count mod 6), rounded up to a multiple
of the mesh's pixel axis; padding records carry the coordinate 0xFFFF.
The coherent order sorts the records stably by the class of their
jitter-free central ray's first hit (padding, miss, emissive, diffuse,
specular, refractive), raster order breaking ties, and with S pixel
shards deals the sorted records round-robin into S contiguous slices.
The classes are computed on the host, as the renderer computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import Material, Scene, Vec3, intersect_scene, pixel_to_ray

DUMMY = 0xFFFF
TILES = 1472
WORKERS = 6


def worklist_size(width: int, height: int, multiple_of: int = 1) -> int:
    rays = int(np.ceil(width * height / float(TILES)))
    rays += rays % WORKERS
    size = max(WORKERS, rays) * TILES
    if multiple_of > 1 and size % multiple_of:
        size += multiple_of - size % multiple_of
    return size


def raster_records(width: int, height: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """(u, v) of each record in raster order, padded to ``size``."""
    n = width * height
    u = np.full(size, DUMMY, np.int64)
    v = np.full(size, DUMMY, np.int64)
    u[:n] = np.tile(np.arange(width), height)
    v[:n] = np.repeat(np.arange(height), width)
    return u, v


def primary_hit_class(scene: Scene, u: np.ndarray, v: np.ndarray, width: int, height: int,
                      fov_degrees: float) -> np.ndarray:
    scene = scene.to("cpu")
    cols = torch.from_numpy(u.astype(np.float32))
    rows = torch.from_numpy(v.astype(np.float32))
    d = pixel_to_ray(cols, rows, width, height, float(np.float32(np.deg2rad(fov_degrees))))
    hit = intersect_scene(scene, Vec3.zeros(cols.shape, device="cpu"), d.normalized())
    mat = hit.material.numpy()
    key = np.where(mat == int(Material.DIFFUSE), 2,
                   np.where(mat == int(Material.SPECULAR), 3, 4))
    key = np.where(hit.emissive.numpy(), 1, key)
    key = np.where(hit.valid.numpy(), key, 0)
    return np.where(u == DUMMY, -1, key)


def coherent_worklist(scene: Scene, width: int, height: int, fov_degrees: float,
                      shards: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """(u, v) of each record of the renderer's coherent worklist."""
    u, v = raster_records(width, height, worklist_size(width, height, shards))
    key = primary_hit_class(scene, u, v, width, height, fov_degrees)
    perm = np.lexsort((np.arange(len(u)), key))
    if shards > 1:
        perm = np.concatenate([perm[i::shards] for i in range(shards)])
    return u[perm], v[perm]
