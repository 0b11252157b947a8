"""The plain reference's render of chosen worklist records.

``replay`` renders, for some records of the worklist, every sample that
the renderer's device film took in a run: step k's seed words (a CPU
generator seeded with the render seed), folded per mesh shard (pixel
shard i, sample replica j) when the render ran on a mesh, and sample s of
record p keyed by p's index within its pixel shard.  A uniform step takes
``spp`` samples a record (each sample replica its share); an adaptive
step takes the budget of the record's block.  It returns each record's
sums of radiance (env light included), path lengths and samples, summed
in f64 over (record, sample) lanes, and of each sample's squared
luminance (the adaptive controller's second moment), that it traces in large batches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .budgets import BUDGET_BLOCK, LUM_B, LUM_G, LUM_R
from .geometry import Scene
from .nif import Nif, env_light
from .trace import Settings, noise_rows, shard_seed, trace_paths


class Layout(NamedTuple):
    """How the run split its worklist: ``mesh`` (the sharded step, even on
    a 1x1 mesh), pixel shards of ``per_shard`` records, sample replicas."""

    mesh: bool
    pixel_shards: int
    sample_replicas: int
    per_shard: int


class Sums(NamedTuple):
    r: np.ndarray  # f64
    g: np.ndarray
    b: np.ndarray
    path_length: np.ndarray  # int64
    sample_count: np.ndarray  # int64
    lum2: np.ndarray  # f64: the sum of each sample's squared Rec.709 luminance


def replay(scene: Scene, st: Settings, nif: Nif, records: np.ndarray, u: np.ndarray,
           v: np.ndarray, seeds: list, layout: Layout, spp: int, budgets=None, *,
           precision: str = "bf16", block: int = BUDGET_BLOCK, lanes_per_batch: int = 1 << 20,
           device="cpu") -> Sums:
    """Sums of the worklist records ``records`` (global indices; ``u``,
    ``v`` their pixels) over the steps of ``seeds``.  ``budgets[k]`` is
    step k's (G,) budget tensor of an adaptive render (one device only)."""
    if budgets is not None and layout.mesh and layout.pixel_shards * layout.sample_replicas > 1:
        raise NotImplementedError("the reference replays adaptive budgets on one device only")
    n = len(records)
    acc = torch.zeros((4, n), dtype=torch.float64, device=device)
    plen = torch.zeros(n, dtype=torch.int64, device=device)
    count = torch.zeros(n, dtype=torch.int64, device=device)
    rec = torch.as_tensor(np.asarray(records, np.int64), device=device)
    shard = rec // layout.per_shard
    local = rec - shard * layout.per_shard
    cols_all = torch.as_tensor(np.asarray(u, np.float32), device=device)
    rows_all = torch.as_tensor(np.asarray(v, np.float32), device=device)
    spp_local = spp // layout.sample_replicas
    for k, step_seed in enumerate(seeds):
        for i in range(layout.pixel_shards):
            mine = torch.nonzero(shard == i).squeeze(1)
            if not mine.numel():
                continue
            if budgets is None:
                per = torch.full_like(mine, spp_local)
            else:
                per = budgets[k].to(device=device, dtype=torch.int64)[local[mine] // block]
            for j in range(layout.sample_replicas):
                key = shard_seed(step_seed, i, j) if layout.mesh else step_seed
                _render_lanes(scene, st, nif, key, mine, local[mine], per, cols_all, rows_all,
                              acc, plen, precision, lanes_per_batch)
                count.index_add_(0, mine, per)
    acc = acc.cpu().numpy()
    return Sums(acc[0], acc[1], acc[2], plen.cpu().numpy(), count.cpu().numpy(), acc[3])


def _render_lanes(scene, st, nif, key, idx, local, per, cols_all, rows_all, acc, plen,
                  precision, lanes_per_batch) -> None:
    """Samples 0 .. per[m] - 1 of records ``idx`` (within-shard indices
    ``local``), accumulated into ``acc`` and ``plen`` at ``idx``."""
    total = int(per.sum())
    if not total:
        return
    owner = torch.repeat_interleave(torch.arange(len(idx), device=idx.device), per)
    start = torch.cumsum(per, 0) - per
    sample = torch.arange(total, device=idx.device) - start[owner]
    for lo in range(0, total, lanes_per_batch):
        o = owner[lo:lo + lanes_per_batch]
        noise = noise_rows(key, local[o], sample[lo:lo + lanes_per_batch], st.max_path_length,
                           st.aa_noise_type)
        dest = idx[o]
        path = trace_paths(scene, st, cols_all[dest], rows_all[dest], noise)
        env = env_light(nif, path.esc_dir, path.esc_w, path.escaped, st.azimuth, precision)
        x, y, z = path.radiance.x + env.x, path.radiance.y + env.y, path.radiance.z + env.z
        lum = LUM_R * x + LUM_G * y + LUM_B * z
        acc.index_add_(1, dest, torch.stack([x, y, z, lum * lum]).to(torch.float64))
        plen.index_add_(0, dest, path.path_len.to(torch.int64))
