"""Worklists: construction, the coherent order, the double buffer and
the load balancer.

Counterpart of ``ipu_path_trace_tpu/runtime/worklist.py``: the padded
whole-image worklist; ``coherent_order``, which sorts records by the
primary-hit class of their jitter-free central ray so that neighbouring
rays (one kernel block, one warp) tend to end their paths together; the
double-buffered ``WorkList`` (the card renders into the active buffer
while the host task works on the inactive one); and the reference's
``LoadBalancer`` (``--enable-load-balancing``): the seed-142 shuffle and
the per-step re-deal of (shortest, longest) path pairs to each virtual
tile.  The re-deal and the clear run in the native host runtime
(runtime/native.py); their NumPy versions below are the plain versions.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..core.camera import pixel_to_ray
from ..core.geometry import intersect_scene
from ..core.records import DUMMY_COORD, TRACE_RECORD_DTYPE, make_worklist
from ..core.scene import Material, Scene
from ..core.vecmath import Vec3
from . import native

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


def create_tracing_jobs(width: int, height: int, num_tiles: int = VIRTUAL_TILES,
                        multiple_of: int = 1) -> np.ndarray:
    """Padded whole-image worklist (padding records carry DUMMY_COORD),
    its size rounded up to a multiple of ``multiple_of`` (a mesh's pixel
    axis, so that the shards divide it evenly)."""
    size = calculate_max_rays_per_tile(width, height, num_tiles) * num_tiles
    if multiple_of > 1 and size % multiple_of:
        size += multiple_of - size % multiple_of
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
                   fov_degrees: float, shards: int = 1) -> np.ndarray:
    """Records stably sorted by primary-hit class (raster order breaks
    ties).  With ``shards`` > 1 the sorted order is dealt round-robin into
    that many contiguous chunks: each mesh shard gets an even mix of
    classes, and each chunk stays sorted."""
    key = primary_hit_class(scene, worklist["u"], worklist["v"], width, height, fov_degrees)
    perm = np.lexsort((np.arange(len(worklist)), key))
    if shards > 1:
        if len(perm) % shards:
            raise ValueError(f"worklist size {len(perm)} does not divide into {shards} shards")
        perm = np.concatenate([perm[i::shards] for i in range(shards)])
    return worklist[perm]


def deal_order(path_length: np.ndarray, num_tiles: int) -> np.ndarray:
    """Plain version of the native re-deal (csrc/pt_host.cpp
    pt_load_balance), as the order it puts the records in: sort stably by
    path length; pair j = (sorted[j], sorted[n-1-j]) goes to tile j % t
    in round j // t; tiles flatten tile-major with their pairs in round
    order, and an odd middle record ends tile 0's run."""
    deal_order.calls += 1
    order = np.argsort(path_length, kind="stable")
    n = len(order)
    t = max(num_tiles, 1)
    m = n // 2
    j = np.arange(m, dtype=np.int64)
    by_tile = np.argsort(j % t, kind="stable")  # tile-major, round order
    idx = np.stack([by_tile, n - 1 - by_tile], axis=1).reshape(-1)
    if n % 2:
        idx = np.insert(idx, 2 * ((m + t - 1) // t), m)
    return order[idx]


deal_order.calls = 0


def clear_and_sum_plain(records: np.ndarray) -> int:
    """Plain version of the native clear: zero the accumulators in place
    and return the path-length sum."""
    clear_and_sum_plain.calls += 1
    total = int(records["pathLength"].sum(dtype=np.int64))
    for field in ("r", "g", "b", "sampleCount", "pathLength"):
        records[field] = 0
    return total


clear_and_sum_plain.calls = 0


class WorkList:
    """Double-buffered record list: the card renders into ``active``
    while the host task accumulates ``inactive``."""

    def __init__(self, size: int):
        self.active = np.zeros(size, TRACE_RECORD_DTYPE)
        self.inactive = np.zeros(size, TRACE_RECORD_DTYPE)

    def swap(self) -> None:
        self.active, self.inactive = self.inactive, self.active
        if self.active.size == 0:
            raise RuntimeError("The new active worklist is empty.")


class LoadBalancer:
    """Work scheduling state: the double buffer and the virtual tiles the
    re-deal deals to.  ``native=False`` runs the plain versions."""

    def __init__(self, work_item_count: int, num_tiles: int = VIRTUAL_TILES,
                 native: bool = True):
        self.work = WorkList(work_item_count)
        self.num_tiles = num_tiles
        self.native = native

    def randomise_work_list(self, worklist: np.ndarray, seed: int = 142) -> None:
        """Shuffle with the reference's fixed seed and install the result
        as the inactive list."""
        shuffled = worklist.copy()
        np.random.default_rng(seed).shuffle(shuffled)
        self.work.inactive = shuffled

    def allocate_work_by_path_length(self) -> None:
        """Re-deal the inactive list: (shortest, longest) path pairs to
        each virtual tile in turn."""
        records = self.work.inactive
        if self.native:
            native.load_balance(records, self.num_tiles)
        else:
            self.work.inactive = records[deal_order(records["pathLength"], self.num_tiles)]

    def clear_inactive_accumulators(self) -> int:
        """Zero the inactive list's accumulators; returns its path-length
        sum (the Rays/sec statistic)."""
        if self.native:
            return native.clear_and_sum_pathlengths(self.work.inactive)
        return clear_and_sum_plain(self.work.inactive)

    def clear_active_accumulators(self) -> None:
        for field in ("r", "g", "b", "sampleCount", "pathLength"):
            self.work.active[field] = 0
