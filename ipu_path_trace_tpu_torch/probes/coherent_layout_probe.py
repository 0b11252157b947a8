"""Raster, coherent and shuffled worklist layouts, on K3.

Counterpart of ``scripts/coherent_layout_probe.py``.  The reference's
load balancer deals short and long paths to each tile to even out MIMD
tiles; a SIMD kernel wants the opposite, similar paths together, so whole
tiles finish together.  The coherent layout (``--layout coherent``, the
CLI's default: ``runtime/worklist.coherent_order``) sorts the worklist
by the primary-hit class of each pixel's centre ray (sky miss, emissive,
diffuse, specular, refractive: ``primary_hit_key``); ``--layout raster``
keeps row order; the seed-142 shuffle is the load balancer's.  For each,
at 1104x1000 and 300 spp with ``assets/nif_w192e16`` through
``render_step`` (K3): the ms a sample (CUDA events over at least
``--min-seconds``, 10) and the dead fraction - (tile, sample) pairs with
no escape, at K3's chain tile and at the JAX kernel's 2048-lane block
(``envskip_bench.escape_stats``, ``--samples`` 4).

    python3 -m ipu_path_trace_tpu_torch.probes.coherent_layout_probe --out DIR [assets] \\
        [--width 1104 --height 1000] [--spp 300] [--min-seconds 10] [--samples 4] \\
        [--device cuda|cpu]

writes ``DIR/coherent_layout_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import _study
from .envskip_bench import BLOCK, escape_stats
from .scene_scale_bench import measure


def primary_hit_key(scene, u, v, fov_degrees: float, width: int, height: int) -> np.ndarray:
    """Each record's class key (runtime/worklist.primary_hit_class, which
    the coherent layout sorts by): -1 padding, 0 sky miss, 1 emissive,
    2 diffuse, 3 specular, 4 refractive."""
    from ..runtime.worklist import primary_hit_class

    return primary_hit_class(scene, np.asarray(u), np.asarray(v), width, height, fov_degrees)


def layouts(scene, wl: np.ndarray, width: int, height: int) -> tuple[dict, dict]:
    """({name: permuted worklist}, class fractions) for raster, coherent
    (stable sort by class, raster order breaking ties) and shuffled."""
    key = primary_hit_key(scene, wl["u"], wl["v"], _study.FOV, width, height)
    frac = {int(k): float((key == k).mean()) for k in np.unique(key)}
    raster = np.arange(len(wl))
    perms = {"raster": raster, "coherent": np.lexsort((raster, key)),
             "shuffled": np.random.default_rng(142).permutation(len(wl))}
    return {k: wl[p] for k, p in perms.items()}, frac


def run(args) -> dict:
    from ..core.records import make_worklist
    from ..core.scene import default_scene
    from ..ops.megastep import chain_tile
    from ..render.params import RenderSettings, StaticConfig

    dev = _study.device_of(args.device, "coherent_layout_probe")
    smi = _study.card(dev)
    env = _study.load_env(args.assets, dev)
    tile = chain_tile(env.model)
    scene = default_scene(dev)
    w, h = args.width, args.height
    cfg = StaticConfig(width=w, height=h)
    settings = RenderSettings.make(samples_per_step=args.spp)
    orders, frac = layouts(scene, make_worklist(w, h), w, h)
    print(f"primary-hit class fractions: {frac}", file=sys.stderr, flush=True)
    out = {"frame": [w, h], "spp": args.spp, "chain_tile": tile, "block": BLOCK,
           "class_fractions": frac, "layouts": {}, "device": smi}
    for name, wl in orders.items():
        row = measure(scene, env, cfg, wl, args.spp, args.min_seconds, dev)
        work = _study.batch(wl, dev)
        _, dead = escape_stats(scene, settings, cfg, work.u.to(torch.float32),
                               work.v.to(torch.float32), _study.base(args.seed, 42),
                               args.samples, (tile, BLOCK))
        row.update(dead_fraction_chain_tile=dead[tile], dead_fraction_block=dead[BLOCK])
        out["layouts"][name] = row
        print(f"[{name:8s}] {row['mpaths_per_s']:.1f} Mpaths/s ({row['ms_per_sample']:.4f} ms/"
              f"sample), dead {dead[tile]:.4f} at {tile} rays, {dead[BLOCK]:.4f} at {BLOCK} "
              f"({smi})", flush=True)
    r = out["layouts"]
    out["coherent_vs_raster"] = r["raster"]["ms_per_sample"] / r["coherent"]["ms_per_sample"]
    out["shuffled_vs_raster"] = r["raster"]["ms_per_sample"] / r["shuffled"]["ms_per_sample"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="coherent_layout_probe",
                                 description=__doc__.split("\n")[0])
    _study.add_common(ap)
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    ap.add_argument("--spp", type=int, default=300)
    ap.add_argument("--min-seconds", type=float, default=10.0)
    ap.add_argument("--samples", type=int, default=4,
                    help="samples for the dead fractions")
    args = ap.parse_args(argv)
    out = _study.out_dir(args.out)
    result = run(args)
    _study.write_json(out, "coherent_layout_probe.json", result)
    print(json.dumps({k: result[k] for k in ("coherent_vs_raster", "shuffled_vs_raster")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
