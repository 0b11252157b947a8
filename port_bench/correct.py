"""What decides ``correct``: the final state of the window's device film
against the plain reference (``port_bench/reference/``).

The renderer's exit checkpoint holds the film as the window left it:
each worklist record's pixel, rgb sums, sample count and path-length sum
(and, adaptive, its squared-luminance sum).  The reference works out for
itself, from the configuration, the traffic and the seed:

- ``order_mismatch``: records whose pixel is not the reference's
  coherent worklist's, dealt over the mesh's pixel shards (exact);
- ``count_mismatch``: records whose sample count is not what the window's
  steps add (exact): steps x samples a step, or, adaptive, the sum of the
  budgets of the record's block;
- ``budget_mismatch`` (adaptive): blocks whose budget the reference's
  controller, run on the renderer's own state before each step, gives
  otherwise, summed over every step of the window (exact);
- ``plen_mismatch``: chosen records whose path-length sum is not the
  reference's (exact: the kernels replay the plain trace);
- ``rgb_rel_l1``: over chosen records and channels, the sum of |film -
  reference| over the sum of |reference|: the NIF chain at every escape,
  and the accumulation;
- ``lum2_rel_l1`` (adaptive): the same for the squared-luminance sums.

The chosen records are ``sample`` real records drawn from the seed and
the ``longest`` records by path length.  Each number has its limit in
``limits/<cell>.json``; ``correct`` holds when every number is within its
limit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cells import ROOT
from .reference.budgets import BUDGET_BLOCK, compute_budgets
from .reference.geometry import scene_for
from .reference.nif import load_nif
from .reference.replay import Layout, replay
from .reference.trace import Settings, step_seeds
from .reference.worklist import coherent_worklist, raster_records, worklist_size


class BudgetLog(NamedTuple):
    """The adaptive controller's calls in the window, one a step, each as
    ((r, g, b, lum2, sample_count, keywords), budgets)."""

    calls: list

    @property
    def budgets(self) -> list:
        return [out for _, out in self.calls]


def mesh_layout(traffic: dict, records: int) -> Layout:
    ipus, shape = int(traffic["ipus"]), traffic["mesh_shape"]
    if shape:
        px, sm = (int(x) for x in shape.lower().split("x"))
    else:
        px, sm = ipus, 1
    return Layout(ipus > 1 or bool(shape), px, sm, records // px)


def settings(config: dict) -> Settings:
    return Settings.make(int(config["width"]), int(config["height"]),
                         fov_degrees=float(config["fov"]),
                         max_path_length=int(config["max_path_length"]),
                         aa_noise_type=config["aa_noise_type"])


def choose_records(state: dict, width: int, seed: int, sample: int, longest: int) -> np.ndarray:
    real = np.nonzero(state["u"] < width)[0]
    rng = np.random.default_rng(seed)
    picked = rng.choice(real, size=min(sample, len(real)), replace=False)
    by_length = real[np.argsort(state["path_length"][real], kind="stable")[::-1][:longest]]
    return np.unique(np.concatenate([picked, by_length]))


def rel_l1(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-300))


def _scene(config: dict, device="cpu"):
    return scene_for(str(ROOT / config["scene"]) if config["scene"] else "", device)


def reference_sums(cell, seed: int, state: dict, steps: int, budget_log: BudgetLog | None,
                   records: np.ndarray, device, precision: str | None = None):
    """The reference's sums of ``records`` over the window's steps, in
    ``precision``: by default the configuration's ``nif_precision``, which
    the reference refuses where it has no such chain; "fp8" is the
    control's."""
    c, t = cell.config, cell.traffic
    precision = precision or c["nif_precision"]
    scene = _scene(c, device)
    nif = load_nif(str(ROOT / c["asset"]), precision, device)
    if nif.widths() != [list(w) for w in c["layers"]]:
        raise ValueError(f"the asset's layers {nif.widths()} are not the configuration's")
    layout = mesh_layout(t, len(state["u"]))
    seeds = step_seeds(seed, steps)
    budgets = None if budget_log is None else budget_log.budgets
    return replay(scene, settings(c), nif, records, state["u"][records], state["v"][records],
                  seeds, layout, int(t["samples_per_step"]), budgets, precision=precision,
                  device=device)


def check_run(cell, seed: int, state: dict, steps: int, budget_log: BudgetLog | None, device,
              *, sample: int = 1024, longest: int = 32) -> tuple[dict, tuple | None]:
    """Every number compared, as {name: value}; ``judge`` holds them to
    their limits.  Also returns the chosen records and the reference's
    sums of them, or None where an exact number already failed (the
    records are then not rendered again)."""
    c, t = cell.config, cell.traffic
    width, height = int(c["width"]), int(c["height"])
    layout = mesh_layout(t, len(state["u"]))
    out = {}
    # The worklist: its size, padding and order.
    size = worklist_size(width, height, layout.pixel_shards)
    if c["layout"] == "coherent":
        u, v = coherent_worklist(_scene(c), width, height, float(c["fov"]), layout.pixel_shards)
    else:
        u, v = raster_records(width, height, size)
    if len(state["u"]) != size:
        out["order_mismatch"] = size
    else:
        out["order_mismatch"] = int(((state["u"] != u) | (state["v"] != v)).sum())
    # The samples each record took.
    spp = int(t["samples_per_step"])
    if budget_log is None:
        want = np.full(len(state["u"]), steps * spp, np.int64)
    else:
        if len(budget_log.calls) != steps:  # a step without its controller, or more
            out["budget_mismatch"] = abs(len(budget_log.calls) - steps)
            return out, None
        total = torch.stack([b.to(torch.int64) for b in budget_log.budgets]).sum(0)
        want = total.repeat_interleave(BUDGET_BLOCK)[:len(state["u"])].cpu().numpy()
        out["budget_mismatch"] = sum(_budget_gap(call) for call in budget_log.calls)
    out["count_mismatch"] = int((state["sample_count"].astype(np.int64) != want).sum())
    if any(out.values()):
        return out, None  # not correct already: the film is not the window's steps
    # Chosen records, rendered again.
    records = choose_records(state, width, seed, sample, longest)
    ref = reference_sums(cell, seed, state, steps, budget_log, records, device)
    out["plen_mismatch"] = int((state["path_length"][records].astype(np.int64)
                                != ref.path_length).sum())
    got = np.stack([state[k][records].astype(np.float64) for k in "rgb"])
    out["rgb_rel_l1"] = rel_l1(got, np.stack([ref.r, ref.g, ref.b]))
    if budget_log is not None:
        out["lum2_rel_l1"] = rel_l1(state["lum2"][records].astype(np.float64), ref.lum2)
    return out, (records, ref)


def _budget_gap(call: tuple) -> int:
    """Blocks whose budget the reference's controller gives otherwise on
    the same inputs."""
    (r, g, b, lum2, count, kw), program = call
    ref = compute_budgets(r, g, b, lum2, count, block_size=kw["block_size"],
                          samples_per_step=kw["samples_per_step"], min_spp=kw["min_spp"],
                          max_spp=kw["max_spp"])
    return int((ref != program).sum())


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": v, "limit": l}})."""
    checks = {}
    ok = True
    for name, value in values.items():
        if name not in limits:
            raise KeyError(f"no limit for {name!r}")
        limit = limits[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, checks
