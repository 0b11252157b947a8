"""Deterministic synthetic HDR environments at the reference's scale.

A numpy copy of ``ipu_path_trace_tpu/models/synth_env.py`` (the port
imports nothing of the JAX package): the same generator, bit for bit, so
the on-class quality gate (probes/quant_psnr.py) scores the port's NIF
against the image the shipped assets were trained on.

The reference's canonical NIF asset encodes a real 2048x4096 urban-alley
HDRI (reference: nif_models/urban_alley_01_4k_fp16_yuv/assets.extra/
nif_metadata.txt - ``original_image_shape: [2048, 4096, 3]``,
``name: .../urban_alley_01_4k.exr``).  That HDRI is not redistributable, so the framework ships a
deterministic generator for a synthetic stand-in with the same *content
class*: a narrow strip of bright sky with a hard sun, tall facades with
sharp window grids (dense high-frequency edges, some windows lit far
above the diffuse level), and a dark ground plane with street lights -
the frequency content and the >4-decade dynamic range that make
urban-alley HDRIs hard for a NIF, at the reference's full resolution.

Everything derives from ``numpy.random.default_rng(seed)``, so the
image regenerates bit-identically from the recorded (height, width,
seed) - the shipped NIF assets' ``train_command`` records the
``synth:urban-alley:<H>x<W>:seed<N>`` pseudo-path instead of a 100 MB
EXR (the trainer, models/train_nif.py of the JAX package, resolves the
scheme back through its own copy of this module).
"""

from __future__ import annotations

import functools
import re

import numpy as np


def _value_noise(rng, height, width, octaves) -> np.ndarray:
    """Multi-octave bilinear value noise in [0, ~1), one channel."""
    img = np.zeros((height, width), np.float64)
    for cells, amp in octaves:
        coarse = rng.random((cells, 2 * cells))
        ys = np.linspace(0, cells - 1, height)
        xs = np.linspace(0, 2 * cells - 1, width)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, cells - 1)
        x1 = np.minimum(x0 + 1, 2 * cells - 1)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        img += amp * (
            coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + coarse[np.ix_(y1, x0)] * fy * (1 - fx)
            + coarse[np.ix_(y0, x1)] * (1 - fy) * fx
            + coarse[np.ix_(y1, x1)] * fy * fx
        )
    return img


def make_urban_env(
    height: int = 2048, width: int = 4096, seed: int = 7
) -> np.ndarray:
    """Synthetic urban-alley-class equirect HDRI (RGB float32, linear).

    Layout (equirect rows = polar angle): a sky band at the top with a
    small very bright sun, building facades from a per-azimuth skyline
    down to the horizon with sharp window grids, and ground below the
    horizon with dim texture plus a handful of street lights.
    """
    rng = np.random.default_rng(seed)
    img = np.zeros((height, width, 3), np.float64)
    horizon = int(0.52 * height)  # camera slightly above street level

    # --- sky: smooth blue-grey gradient, brightest near the zenith ---
    rows = np.arange(height, dtype=np.float64)[:, None]
    sky_t = np.clip(rows / horizon, 0.0, 1.0)  # 0 zenith .. 1 horizon
    sky = np.empty((height, width, 3), np.float64)
    sky[..., 0] = 3.0 * (1.0 - 0.55 * sky_t)  # R
    sky[..., 1] = 4.2 * (1.0 - 0.45 * sky_t)  # G
    sky[..., 2] = 6.5 * (1.0 - 0.30 * sky_t)  # B
    cloud = _value_noise(rng, height, width, ((6, 0.5), (24, 0.3), (96, 0.2)))
    sky *= (0.7 + 0.6 * cloud)[..., None]

    # --- skyline: blocky per-azimuth building tops (tall alley walls) ---
    n_buildings = max(8, width // 96)
    edges = np.sort(rng.choice(width, n_buildings, replace=False))
    tops = rng.uniform(0.08, 0.42, n_buildings) * height
    col_building = np.searchsorted(edges, np.arange(width), side="right") % n_buildings
    skyline = tops[col_building]  # (W,) rows where facade starts

    facade_mask = (rows >= skyline[None, :]) & (rows < horizon)
    sky_mask = (rows < horizon) & ~facade_mask
    img += sky * sky_mask[..., None]

    # --- facades: dark diffuse walls + sharp window grids ---
    wall_tint = rng.uniform(0.02, 0.12, (n_buildings, 3))
    wall = wall_tint[col_building][None, :, :] * np.ones((height, 1, 1))
    tex = _value_noise(rng, height, width, ((64, 0.6), (256, 0.4)))
    wall = wall * (0.6 + 0.8 * tex)[..., None]
    # Window grid: cell lattice in (row, col); window = inner 60% of cell.
    cell_h = max(4, height // 160)
    cell_w = max(4, width // 320)
    in_win = (
        ((np.arange(height) % cell_h) < int(0.6 * cell_h))[:, None]
        & ((np.arange(width) % cell_w) < int(0.6 * cell_w))[None, :]
    )
    # Per-cell lit state: ~12% of windows glow 20..400x the wall level.
    grid_h = -(-height // cell_h)
    grid_w = -(-width // cell_w)
    lit = rng.random((grid_h, grid_w)) < 0.12
    glow = rng.uniform(20.0, 400.0, (grid_h, grid_w)) * lit
    glow_tint = rng.uniform(0.5, 1.0, (grid_h, grid_w, 3))
    glow_tint[..., 2] *= 0.6  # tungsten-ish
    cell_r = np.arange(height) // cell_h
    cell_c = np.arange(width) // cell_w
    glow_rgb = glow[..., None] * glow_tint  # (grid_h, grid_w, 3)
    win_glow = glow_rgb[cell_r][:, cell_c]  # (H, W, 3)
    win_dark = 0.3  # unlit glass darker than the wall
    facade = np.where(in_win[..., None], wall * win_dark + win_glow, wall)
    img += facade * facade_mask[..., None]

    # --- ground: dark asphalt with texture below the horizon ---
    ground_mask = rows >= horizon
    asphalt = 0.04 * (0.5 + tex)[..., None] * np.array([1.0, 0.95, 0.9])
    img += asphalt * ground_mask[..., None]

    # --- sun: small disc + halo, far above everything (sky region only) ---
    yy = np.arange(height, dtype=np.float64)[:, None]
    xx = np.arange(width, dtype=np.float64)[None, :]
    sun_y = rng.uniform(0.08, 0.2) * height
    sun_x = rng.uniform(0.0, 1.0) * width
    d2 = (yy - sun_y) ** 2 + (xx - sun_x) ** 2
    sun_sigma = 0.004 * height
    sun = 3.0e4 * np.exp(-d2 / (2 * sun_sigma**2)) + 200.0 * np.exp(
        -d2 / (2 * (6 * sun_sigma) ** 2)
    )
    img += (sun * (~facade_mask & (rows < horizon)))[..., None] * np.array(
        [1.0, 0.95, 0.85]
    )

    # --- street lights: bright Gaussians near the horizon line ---
    for _ in range(16):
        cy = horizon + rng.uniform(-0.02, 0.06) * height
        cx = rng.uniform(0, width)
        sigma = rng.uniform(1.5, 5.0)
        power = rng.uniform(100.0, 1200.0)
        tint = np.array([1.0, rng.uniform(0.7, 0.95), rng.uniform(0.4, 0.7)])
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        img += (power * np.exp(-d2 / (2 * sigma * sigma)))[..., None] * tint

    return np.maximum(img, 1e-4).astype(np.float32)


_SYNTH_RE = re.compile(r"^synth:urban-alley:(\d+)x(\d+):seed(\d+)$")


def resolve_synth(path: str) -> np.ndarray | None:
    """Resolve a ``synth:urban-alley:<H>x<W>:seed<N>`` pseudo-path.

    Returns the generated image, or None when ``path`` is not a synth
    scheme (the caller then treats it as a real file).  Recorded in
    shipped assets' train_command so they replay without a 100 MB EXR.
    The last image is kept (a 2048x4096 one takes seconds to make, and the
    trainer, the QAT fine-tune and the quality gate each ask for it), so it
    is read-only: a caller copies it before writing.
    """
    m = _SYNTH_RE.match(path)
    if m is None:
        if path.startswith("synth:"):
            raise ValueError(
                f"unknown synth env scheme '{path}' "
                "(expected synth:urban-alley:<H>x<W>:seed<N>)"
            )
        return None
    h, w, seed = (int(g) for g in m.groups())
    return _urban_env(h, w, seed)


@functools.lru_cache(maxsize=1)
def _urban_env(height: int, width: int, seed: int) -> np.ndarray:
    img = make_urban_env(height, width, seed)
    img.setflags(write=False)
    return img
