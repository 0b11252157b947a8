"""Shared parts of the sampling and device-time studies.

The studies (``probes/adaptive_bench.py``, ``sobol_bench.py``,
``denoise_bench.py``, ``adaptive_depth_check.py``,
``adaptive_knob_sweep.py`` and the device-time probes) are the
counterparts of the JAX package's ``scripts/*_bench.py``.  What they have
in common lives here:

  * the device: ``cuda`` unless ``--device cpu`` (the plain versions);
    ``cuda`` without a card raises;
  * the coherent worklist and its padding mask (records whose u is
    ``core/records.DUMMY_COORD`` are no pixel);
  * seeds: each curve has its own base words (``base(seed, tag)``: the
    JAX scripts' ``make_base_key(tag)``), and step s of a curve is
    ``parallel/mesh.fold_seed(base, s)`` (their ``fold_in(base, s)``), so
    the ground truth (tag 101) draws streams independent of every curve
    (tag 7) and of the warm-up (tag 999);
  * the ground-truth render, and the f64 RMSE of the running per-pixel
    mean over the valid records (``mean_rgb``, the scripts' ``_mean_rgb``);
  * the timed window (``Window``): CUDA events for the device time and the
    host clock for the wall time, synchronised at its end.  The warm-up
    step (which includes the kernels' first build) and every RMSE run
    outside it.

Each probe writes only under its ``--out`` directory: one JSON with the
keys of the JAX package's record (``docs/*.json``, TPU runs) and, for the
figure tools, a PNG.  Those records' seconds and rates are a TPU's; their
dimensionless ratios (sample efficiency, equal-quality multipliers,
escape and dead-block fractions) describe the algorithm and are what the
port's are compared with.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_ASSETS = ROOT / "assets" / "nif_w192e16"
SCENES = ROOT / "assets" / "scenes"
FOV = 90.0
GT_TAG, CURVE_TAG, WARM_TAG = 101, 7, 999  # the JAX scripts' make_base_key seeds
GT_STEP = 512  # ground-truth samples per step


def add_common(ap: argparse.ArgumentParser, assets: bool = True, seed: bool = True) -> None:
    """--out and --device (and --seed and the optional assets directory)."""
    ap.add_argument("--out", required=True, help="directory for the probe's JSON (and PNG)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain versions")
    if seed:
        ap.add_argument("--seed", type=int, default=0,
                        help="second word of every curve's base seed")
    if assets:
        ap.add_argument("assets", nargs="?", default=str(DEFAULT_ASSETS),
                        help="NIF assets directory (default assets/nif_w192e16)")


def add_check_steps(ap: argparse.ArgumentParser, default) -> None:
    ap.add_argument("--check-steps", default=",".join(map(str, default)),
                    type=lambda s: tuple(int(x) for x in s.split(",")),
                    help="steps after which the RMSE is taken (increasing)")


def device_of(name: str, prog: str) -> torch.device:
    """The probe's device; ``cuda`` without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: CUDA is not available; --device cpu runs the plain versions")
    return dev


def out_dir(path: str) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def card(dev: torch.device) -> str:
    """nvidia-smi's name and power limit (every time goes beside them), or
    the CPU's label: no CPU number is a device metric."""
    from ..utils.devtime import card_line, device_label

    return card_line(dev) if dev.type == "cuda" else device_label(dev)


def write_json(directory: Path, name: str, result: dict) -> Path:
    path = directory / name
    path.write_text(json.dumps(result, indent=2) + "\n")
    return path


def base(seed: int, tag: int) -> tuple[int, int]:
    """A curve's base seed words."""
    return int(tag) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF


def step_seed(base_words: tuple[int, int], step: int) -> tuple[int, int]:
    """Step ``step``'s seed words of the curve ``base_words``."""
    from ..parallel.mesh import fold_seed

    return fold_seed(base_words, step)


def load_env(assets: str, dev: torch.device, precision: str = "auto",
             partials: str = "half"):
    """The NIF env light of an assets directory (bf16 unless int8 or f32)."""
    from ..runtime.app import parse_env_assets

    return parse_env_assets(str(assets), dev, precision, partials)[0]


def coherent_worklist(scene, width: int, height: int, fov: float = FOV):
    """(worklist, mask): the coherent order of the app's default layout, and
    the records that are pixels (not ``DUMMY_COORD`` padding)."""
    from ..core.records import DUMMY_COORD, make_worklist
    from ..runtime.worklist import coherent_order

    wl = coherent_order(make_worklist(width, height), scene, width, height, fov)
    return wl, wl["u"] != DUMMY_COORD


def batch(wl: np.ndarray, dev: torch.device):
    from ..core.records import to_device_batch

    return to_device_batch(wl, dev)


def mean_rgb(work, mask: np.ndarray) -> np.ndarray:
    """(3, M) f64 running per-pixel mean over the valid records
    (scripts/adaptive_bench.py::_mean_rgb on the port's WorkBatch)."""
    cnt = np.maximum(work.sample_count.cpu().numpy(), 1).astype(np.float64)
    m = np.stack([work.r.cpu().numpy(), work.g.cpu().numpy(), work.b.cpu().numpy()])
    return (m / cnt)[:, mask]


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Window:
    """Accumulates the time of the work run inside ``with window:``: device
    seconds between CUDA events (None on the CPU: not measured) and wall
    seconds on the host clock, both synchronised at the end."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.wall = 0.0
        self.device = 0.0 if dev.type == "cuda" else None

    def __enter__(self):
        sync(self.dev)
        if self.device is not None:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            self._ev[1].record()
        sync(self.dev)
        self.wall += time.perf_counter() - self._t0
        if self.device is not None:
            self.device += self._ev[0].elapsed_time(self._ev[1]) / 1e3
        return False


def uniform_steps(scene, env, cfg, work, spp_step: int, seeds) -> object:
    """``render_step`` at ``spp_step`` samples for each seed in turn."""
    from ..render.params import RenderSettings
    from ..render.wavefront import render_step

    settings = RenderSettings.make(samples_per_step=spp_step)
    for seed in seeds:
        work = render_step(scene, settings, cfg, work, seed, env)
    return work


def ground_truth(scene, env, cfg, wl, mask, gt_spp: int, seed: int, dev) -> tuple[np.ndarray,
                                                                                    float]:
    """(mean_rgb, wall seconds) of a uniform render at ``gt_spp`` samples a
    pixel in steps of GT_STEP (fewer when gt_spp is smaller), Philox from
    base (101, seed): streams independent of every curve's."""
    step = min(GT_STEP, gt_spp)
    t0 = time.perf_counter()
    b = base(seed, GT_TAG)
    work = uniform_steps(scene, env, cfg, batch(wl, dev), step,
                         (step_seed(b, s) for s in range(gt_spp // step)))
    sync(dev)
    secs = time.perf_counter() - t0
    return mean_rgb(work, mask), secs


def run_curve(scene, env, cfg, wl, mask, gt, spp_step: int, check_steps, seed: int, dev,
              adaptive: bool, label: str, log=print):
    """The RMSE curve of one sampler against ``gt``: steps of ``spp_step``
    samples (adaptive: the controller's budgets, same total), seeds folded
    from base (7, seed), with the RMSE of the running mean at each
    checkpoint step.  One warm-up step (base (999, seed), the kernels'
    first build) runs before, outside the window.  Returns (points, work,
    lum2); each point has the JAX record's ``total_spp``, ``rmse`` and
    ``seconds`` (wall, synchronised) and ``device_seconds`` (CUDA events)."""
    from ..render.adaptive import adaptive_render_step
    from ..render.params import RenderSettings
    from ..render.wavefront import render_step

    settings = RenderSettings.make(samples_per_step=spp_step)

    def step(work, lum2, seed_words):
        if adaptive:
            return adaptive_render_step(scene, settings, cfg, work, lum2, seed_words, env)
        return render_step(scene, settings, cfg, work, seed_words, env), lum2

    w0 = batch(wl, dev)
    step(w0, torch.zeros(w0.u.shape[0], dtype=torch.float32, device=dev),
         step_seed(base(seed, WARM_TAG), 0))
    sync(dev)
    work = batch(wl, dev)
    lum2 = torch.zeros(work.u.shape[0], dtype=torch.float32, device=dev)
    b = base(seed, CURVE_TAG)
    window = Window(dev)
    pts, done = [], 0
    for ck in check_steps:
        with window:
            while done < ck:
                done += 1
                work, lum2 = step(work, lum2, step_seed(b, done))
        pts.append({"total_spp": ck * spp_step, "rmse": rmse(mean_rgb(work, mask), gt),
                    "seconds": round(window.wall, 4),
                    "device_seconds": None if window.device is None else round(window.device, 4)})
        log(f"[{label}] {ck * spp_step:5d} spp-eq: rmse {pts[-1]['rmse']:.3e} "
            f"({window.wall:.2f} s)")
    return pts, work, lum2


def sample_efficiency(reference: list[dict], curve: list[dict]) -> list[float]:
    """(rmse_ref / rmse_curve)^2 at each checkpoint: how much longer the
    reference curve must run to match (RMSE ~ 1 / sqrt(n))."""
    return [round((r["rmse"] / c["rmse"]) ** 2, 3) for r, c in zip(reference, curve)]
