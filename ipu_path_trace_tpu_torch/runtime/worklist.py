"""Worklist construction and the coherent record order.

Counterpart of the main-path parts of
``ipu_path_trace_tpu/runtime/worklist.py``: the padded whole-image
worklist and ``coherent_order``, which sorts records by the primary-hit
class of their jitter-free central ray so that neighbouring rays (one
kernel block, one warp) tend to end their paths together.  The load
balancer is not ported (ROADMAP queue 1 item 20).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..core.camera import pixel_to_ray
from ..core.geometry import intersect_scene
from ..core.records import DUMMY_COORD, make_worklist
from ..core.scene import Material, Scene
from ..core.vecmath import Vec3

VIRTUAL_TILES = 1472  # the reference's tiles per chip
VIRTUAL_WORKERS = 6

log = logging.getLogger(__name__)


def calculate_max_rays_per_tile(width: int, height: int, num_tiles: int = VIRTUAL_TILES,
                                num_workers: int = VIRTUAL_WORKERS) -> int:
    """Ceil-divide pixels over tiles, then add ``raysPerTile % workers``
    (the reference's quirk, kept for identical worklist sizes)."""
    total = width * height
    if total % (num_tiles * num_workers):
        log.warning("For best performance number of pixels should be divisible "
                    "by %d x %d (tiles x workers).", num_tiles, num_workers)
    rays_per_tile = int(np.ceil(total / float(num_tiles)))
    rays_per_tile += rays_per_tile % num_workers
    return max(num_workers, rays_per_tile)


def create_tracing_jobs(width: int, height: int, num_tiles: int = VIRTUAL_TILES) -> np.ndarray:
    """Padded whole-image worklist (padding records carry DUMMY_COORD)."""
    size = calculate_max_rays_per_tile(width, height, num_tiles) * num_tiles
    return make_worklist(width, height, padded_size=size)


def primary_hit_class(scene: Scene, u: np.ndarray, v: np.ndarray, width: int, height: int,
                      fov_degrees: float) -> np.ndarray:
    """Expected-path-length class of each record's central ray, on the
    host: -1 padding, 0 primary miss, 1 emissive, 2 diffuse, 3 specular,
    4 refractive."""
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
    return np.where(u == DUMMY_COORD, -1, key)


def coherent_order(worklist: np.ndarray, scene: Scene, width: int, height: int,
                   fov_degrees: float) -> np.ndarray:
    """Records stably sorted by primary-hit class (raster order breaks ties)."""
    key = primary_hit_class(scene, worklist["u"], worklist["v"], width, height, fov_degrees)
    return worklist[np.lexsort((np.arange(len(worklist)), key))]
