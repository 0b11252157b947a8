"""The adaptive sampler's floor and cap knobs, swept.

Counterpart of ``scripts/adaptive_knob_sweep.py``.  For each
(adaptive_min, adaptive_max_factor) row, the frame is rendered to 1024
spp-equivalent (8 steps of 128) with the adaptive controller and scored
by its RMSE against a uniform ground truth (``--gt-spp`` 16384); the
sample efficiency is (rmse_uniform / rmse_adaptive)^2 at the same total,
the uniform render on the same step seeds.  The kernel is built once: a
knob is runtime data, so no row pays a build (the JAX record's
``seconds_incl_compile`` paid one each; here it equals ``seconds``).

    python3 -m ipu_path_trace_tpu_torch.probes.adaptive_knob_sweep --out DIR [assets] \\
        [--width 1104 --height 1000 --gt-spp 16384 --spp-step 128 --steps 8] \\
        [--seed 0] [--device cuda|cpu]

writes ``DIR/adaptive_knob_sweep.json``: ``{"knob_sweep": {...}}`` with the
keys of the JAX record's section (``docs/ADAPTIVE.json``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import _study

KNOBS = [  # (adaptive_min, adaptive_max_factor)
    (8, 16.0),  # the shipped defaults
    (8, 2.0), (8, 4.0), (8, 8.0), (8, 32.0),
    (2, 4.0), (32, 4.0),
    (2, 16.0),
]


def run(args) -> dict:
    from ..core.scene import default_scene
    from ..render.adaptive import adaptive_render_step
    from ..render.params import RenderSettings, StaticConfig

    dev = _study.device_of(args.device, "adaptive_knob_sweep")
    env = _study.load_env(args.assets, dev)
    scene = default_scene(dev)
    cfg0 = StaticConfig(width=args.width, height=args.height)
    smi = _study.card(dev)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(f"device: {smi}, frame {args.width}x{args.height}, assets {args.assets}")
    wl, mask = _study.coherent_worklist(scene, args.width, args.height)
    gt, gt_s = _study.ground_truth(scene, env, cfg0, wl, mask, args.gt_spp, args.seed, dev)
    log(f"ground truth {args.gt_spp} spp in {gt_s:.1f} s")
    b = _study.base(args.seed, _study.CURVE_TAG)
    seeds = [_study.step_seed(b, s) for s in range(1, args.steps + 1)]
    rmse_u = _study.rmse(_study.mean_rgb(_study.uniform_steps(
        scene, env, cfg0, _study.batch(wl, dev), args.spp_step, seeds), mask), gt)
    log(f"[uniform] {args.steps * args.spp_step} spp: rmse {rmse_u:.3e}")
    settings = RenderSettings.make(samples_per_step=args.spp_step)
    w0 = _study.batch(wl, dev)  # warm-up: the adaptive step's first build
    adaptive_render_step(scene, settings, cfg0, w0, torch.zeros_like(w0.r),
                         _study.step_seed(_study.base(args.seed, _study.WARM_TAG), 0), env)
    rows = []
    for mn, capf in KNOBS:
        cfg = cfg0._replace(adaptive_min=mn, adaptive_max_factor=capf)
        work = _study.batch(wl, dev)
        lum2 = torch.zeros_like(work.r)
        window = _study.Window(dev)
        with window:
            for k in seeds:
                work, lum2 = adaptive_render_step(scene, settings, cfg, work, lum2, k, env)
        r = _study.rmse(_study.mean_rgb(work, mask), gt)
        rows.append({"min": mn, "max_factor": capf, "rmse": r,
                     "sample_efficiency": round((rmse_u / r) ** 2, 3),
                     "seconds_incl_compile": round(window.wall, 3),
                     "seconds": round(window.wall, 3),
                     "device_seconds": None if window.device is None else round(window.device, 4)})
        log(f"[min={mn:3d} cap={capf:4.1f}] rmse {r:.3e} eff {(rmse_u / r) ** 2:5.2f}x")
    return {"knob_sweep": {"total_spp": args.steps * args.spp_step, "uniform_rmse": rmse_u,
                           "rows": rows},
            "frame": [args.width, args.height], "gt_spp": args.gt_spp, "seed": args.seed,
            "device": smi}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="adaptive_knob_sweep", description=__doc__.split("\n")[0])
    _study.add_common(ap)
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    ap.add_argument("--gt-spp", type=int, default=16384)
    ap.add_argument("--spp-step", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8, help="steps a row (8 x 128 = 1024 spp)")
    args = ap.parse_args(argv)
    out = _study.out_dir(args.out)
    result = run(args)
    _study.write_json(out, "adaptive_knob_sweep.json", result)
    print(json.dumps(result["knob_sweep"]))
    rows = result["knob_sweep"]["rows"]
    return 0 if np.isfinite([r["rmse"] for r in rows]).all() else 1


if __name__ == "__main__":
    sys.exit(main())
