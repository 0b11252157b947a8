"""How often the reference's env-skip could fire, and K3's time per scene.

Counterpart of ``scripts/envskip_bench.py``.  The reference's megastep
skips the NIF chain for a block of rays none of which escapes in a
sample.  K3 has no such skip to switch: it queues each block's escapes
and shades only those (ops/megastep.py), so a block without escapes runs
no chain.  Per scene (the default, ``mirror_hall``, ``glass_caustic``
and an enclosed one - the default spheres inside a giant emissive
diffuse shell, from which no path escapes), on the coherent worklist at
1104x1000, with the synthetic 6x320 NIF
(``models/nif.make_synthetic_nif(0)``, bf16):

  1. escape statistics from the trace (K1 on the card; ``--samples`` 8
     Philox samples): the per-lane escape fraction, and the fraction of
     (block, sample) pairs with no escape - at the JAX kernel's 2048-lane
     block (``dead_block_fraction``, the figure to hold against
     ``docs/ENVSKIP.json``) and at K3's chain tile
     (``ops/megastep.chain_tile``: 128 rays for bf16 and int8, 64 for
     tf32; ``dead_block_fraction_chain_tile``);
  2. K3's ms a sample at 300 spp (CUDA events, ``--reps`` launches after
     a warm one).

    python3 -m ipu_path_trace_tpu_torch.probes.envskip_bench --out DIR \\
        [--samples 8] [--reps 2] [--stats-only] [--width 1104 --height 1000] \\
        [--spp 300] [--device cuda|cpu]

writes ``DIR/envskip_bench.json``: the JAX record's keys, and each scene's
escape and dead-block fractions under the JAX record's names.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import _study

BLOCK = 2048  # the JAX kernel's block, at which docs/ENVSKIP.json counts
SCENES = {"default": None, "mirror_hall": "mirror_hall.json",
          "glass_caustic": "glass_caustic.json", "enclosed": "__enclosed__"}

ENCLOSED = {"objects": [
    {"type": "sphere", "center": [0.0, 0.0, 0.0], "radius": 200.0,
     "colour": [0.6, 0.6, 0.6], "material": "diffuse", "emission": [0.8, 0.8, 0.8]},
    {"type": "sphere", "center": [-0.75, -0.49, -3.25], "radius": 0.51,
     "colour": [0.9, 0.2, 0.2], "material": "diffuse"},
    {"type": "sphere", "center": [0.75, -0.49, -3.25], "radius": 0.51,
     "colour": [0.2, 0.9, 0.2], "material": "specular"},
    {"type": "sphere", "center": [0.0, -0.6, -2.3], "radius": 0.4,
     "colour": [0.9, 0.9, 0.9], "material": "refractive"},
    {"type": "disc", "normal": [0.0, 1.0, 0.0], "center": [0.0, -1.0, -3.0], "radius": 4.0,
     "colour": [0.7, 0.7, 0.7], "material": "diffuse"},
]}


def load(name: str, dev):
    from ..core.scene import default_scene
    from ..core.scenefile import load_scene, scene_from_dict

    path = SCENES[name]
    if path is None:
        return default_scene(dev)
    if path == "__enclosed__":
        return scene_from_dict(ENCLOSED, dev)
    return load_scene(str(_study.SCENES / path), dev)


def escape_stats(scene, settings, cfg, cols, rows, seed, n_samples: int,
                 blocks: tuple[int, ...]) -> tuple[float, dict]:
    """(escape fraction, {block: dead fraction}) over ``n_samples`` Philox
    samples of the trace: a lane escapes when any of its escape weights is
    non-zero; a block is dead when none of its lanes does (the ragged tail
    counts as escaping nothing, as the kernels' masked lanes)."""
    from ..ops.trace import trace_sample

    n = cols.shape[0]
    esc, dead = 0.0, dict.fromkeys(blocks, 0.0)
    for s in range(n_samples):
        st = trace_sample(scene, settings, cols, rows, seed, sample_index=s, width=cfg.width,
                          height=cfg.height, max_path_length=cfg.max_path_length,
                          aa_noise_type=cfg.aa_noise_type)
        esc += float(st.escaped.float().mean())
        lanes = (st.esc_w.stack() != 0.0).any(dim=0)
        for blk in blocks:
            nblk = -(-n // blk)
            padded = torch.nn.functional.pad(lanes, (0, nblk * blk - n))
            dead[blk] += float((~padded.reshape(nblk, blk).any(dim=1)).float().mean())
    return esc / n_samples, {b: d / n_samples for b, d in dead.items()}


def dead_block_fraction(scene, settings, cfg, cols, rows, seed, n_samples: int,
                        block_size: int) -> float:
    """The fraction of (``block_size``-lane block, sample) pairs with no
    escape over ``n_samples`` Philox samples (``escape_stats``)."""
    return escape_stats(scene, settings, cfg, cols, rows, seed, n_samples,
                        (block_size,))[1][block_size]


def k3_ms(scene, settings, model, cols, rows, cfg, reps: int, dev) -> float:
    """K3's ms a sample at ``settings.samples_per_step`` samples a launch."""
    from ..ops.megastep import render_megastep
    from ..utils.devtime import time_per_call

    i = iter(range(1 << 30))
    fn = lambda: render_megastep(  # noqa: E731
        scene, settings, model, cols, rows, (next(i), 3), width=cfg.width, height=cfg.height,
        max_path_length=cfg.max_path_length, aa_noise_type=cfg.aa_noise_type)
    return time_per_call(fn, reps, dev) / settings.samples_per_step * 1e3


def run(args) -> dict:
    from ..models.nif import make_params, make_synthetic_nif
    from ..ops.megastep import chain_tile
    from ..render.params import RenderSettings, StaticConfig

    dev = _study.device_of(args.device, "envskip_bench")
    smi = _study.card(dev)
    weights, meta = make_synthetic_nif(0)  # the canonical 6x320 arch
    model = make_params(weights, meta, torch.bfloat16, dev)
    tile = chain_tile(model)
    cfg = StaticConfig(width=args.width, height=args.height)
    settings = RenderSettings.make(samples_per_step=args.spp)
    out = {"shape": f"{args.width}x{args.height}", "spp": args.spp, "block": BLOCK,
           "chain_tile": tile, "samples": args.samples, "scenes": {}, "device": smi}
    for name in SCENES:
        scene = load(name, dev)
        wl, _ = _study.coherent_worklist(scene, args.width, args.height)
        work = _study.batch(wl, dev)
        cols, rows = work.u.to(torch.float32), work.v.to(torch.float32)
        esc, dead = escape_stats(scene, settings, cfg, cols, rows, _study.base(args.seed, 42),
                                 args.samples, (BLOCK, tile))
        row = {"escape_fraction": round(esc, 4), "dead_block_fraction": round(dead[BLOCK], 4),
               "dead_block_fraction_chain_tile": round(dead[tile], 4)}
        if not args.stats_only:
            row["k3_ms_per_sample"] = round(
                k3_ms(scene, settings, model, cols, rows, cfg, args.reps, dev), 4)
        out["scenes"][name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="envskip_bench", description=__doc__.split("\n")[0])
    _study.add_common(ap, assets=False)
    ap.add_argument("--samples", type=int, default=8,
                    help="samples for the escape statistics")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--stats-only", action="store_true", help="skip K3's timing")
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    ap.add_argument("--spp", type=int, default=300)
    args = ap.parse_args(argv)
    out = _study.out_dir(args.out)
    result = run(args)
    _study.write_json(out, "envskip_bench.json", result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
