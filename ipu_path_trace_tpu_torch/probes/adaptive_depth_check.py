"""Whether the adaptive sampler's speedup holds at production depth.

Counterpart of ``scripts/adaptive_depth_check.py``.  ``adaptive_bench``
measures the sample efficiency up to 2048 spp against a fixed ground
truth; this check reaches tens of thousands of spp without a deeper one,
by the two-seed identity for unbiased estimators:

    E[RMSE(uniA, uniB)^2] = 2 noise_u^2
    E[RMSE(ada,  uniA)^2] = noise_a^2 + noise_u^2

so noise_a <= noise_u  <=>  RMSE(ada, uni) <= RMSE(uniA, uniB).  The
uniform sampler renders ``--n`` (20480) spp twice (seeds 11 and 22), the
adaptive one once (seed 33) at n / ``--speedup`` spp; if the adaptive
image is no noisier than the uniform pair's mutual distance, the claimed
time-to-quality speedup holds at this depth (``holds``).  Pass
``--speedup`` the port's own ``time_to_quality_speedup`` from
``adaptive_bench`` (the JAX record's 4.24 is a TPU's time).

    python3 -m ipu_path_trace_tpu_torch.probes.adaptive_depth_check --out DIR [assets] \\
        [--n 20480 --speedup 2.55] [--width 1104 --height 1000 --spp-step 128] \\
        [--device cuda|cpu]

writes ``DIR/adaptive_depth_check.json``: ``{"depth_check": {...}}`` with
the keys of the JAX record's section (``docs/ADAPTIVE.json``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import _study

SEEDS = {"uniform_a": 11, "uniform_b": 22, "adaptive": 33}


def two_seed_identity(uu: float, au: float, ab: float) -> tuple[float, bool]:
    """(noise_a / noise_u, holds) from RMSE(uniA, uniB), RMSE(ada, uniA)
    and RMSE(ada, uniB), pooled: noise_u^2 = uu^2 / 2, noise_a^2 =
    mean(au^2, ab^2) - noise_u^2 (at least 0); holds when the ratio is at
    most 1 (scripts/adaptive_depth_check.py)."""
    noise_u2 = uu * uu / 2.0
    noise_a2 = max((au * au + ab * ab) / 2.0 - noise_u2, 0.0)
    ratio = float(np.sqrt(noise_a2 / max(noise_u2, 1e-30)))
    return ratio, bool(ratio <= 1.0)


def render(scene, env, cfg, wl, mask, b: tuple[int, int], steps: int, spp_step: int,
           adaptive: bool, dev) -> tuple[np.ndarray, _study.Window]:
    """``steps`` steps of ``spp_step`` samples (adaptive or uniform), step s
    seeded by fold_seed(b, s); (mean_rgb, the timed window)."""
    from ..render.adaptive import adaptive_render_step
    from ..render.params import RenderSettings
    from ..render.wavefront import render_step

    settings = RenderSettings.make(samples_per_step=spp_step)
    work = _study.batch(wl, dev)
    lum2 = torch.zeros(work.u.shape[0], dtype=torch.float32, device=dev)
    window = _study.Window(dev)
    with window:
        for step in range(1, steps + 1):
            k = _study.step_seed(b, step)
            if adaptive:
                work, lum2 = adaptive_render_step(scene, settings, cfg, work, lum2, k, env)
            else:
                work = render_step(scene, settings, cfg, work, k, env)
    return _study.mean_rgb(work, mask), window


def run(args) -> dict:
    from ..core.scene import default_scene
    from ..render.params import StaticConfig

    dev = _study.device_of(args.device, "adaptive_depth_check")
    env = _study.load_env(args.assets, dev)
    scene = default_scene(dev)
    cfg = StaticConfig(width=args.width, height=args.height)
    smi = _study.card(dev)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(f"device: {smi}, frame {args.width}x{args.height}, assets {args.assets}")
    wl, mask = _study.coherent_worklist(scene, args.width, args.height)
    steps_u = args.n // args.spp_step
    steps_a = max(1, round(args.n / args.speedup / args.spp_step))
    # Warm-up outside the timed renders: both step kinds, the kernels' build.
    warm = _study.base(args.seed, _study.WARM_TAG)
    render(scene, env, cfg, wl, mask, warm, 1, args.spp_step, True, dev)
    render(scene, env, cfg, wl, mask, warm, 1, args.spp_step, False, dev)
    images, secs = {}, {}
    for name, seed in SEEDS.items():
        adaptive = name == "adaptive"
        images[name], window = render(scene, env, cfg, wl, mask, _study.base(args.seed, seed),
                                      steps_a if adaptive else steps_u, args.spp_step,
                                      adaptive, dev)
        secs[name] = window
        log(f"[{name} seed {seed}] {(steps_a if adaptive else steps_u) * args.spp_step} spp "
            f"in {window.wall:.1f} s")
    uu = _study.rmse(images["uniform_a"], images["uniform_b"])
    au = _study.rmse(images["adaptive"], images["uniform_a"])
    ab = _study.rmse(images["adaptive"], images["uniform_b"])
    ratio, holds = two_seed_identity(uu, au, ab)
    dev_s = {k: w.device for k, w in secs.items()}
    entry = {
        "uniform_spp": steps_u * args.spp_step, "adaptive_spp": steps_a * args.spp_step,
        "claimed_speedup": args.speedup,
        "rmse_uniA_uniB": uu, "rmse_ada_uniA": au, "rmse_ada_uniB": ab,
        "noise_ratio_a_over_u": round(ratio, 3),
        "seconds": {"uniform": round((secs["uniform_a"].wall + secs["uniform_b"].wall) / 2, 2),
                    "adaptive": round(secs["adaptive"].wall, 2)},
        "device_seconds": None if dev_s["adaptive"] is None else {
            "uniform": round((dev_s["uniform_a"] + dev_s["uniform_b"]) / 2, 3),
            "adaptive": round(dev_s["adaptive"], 3)},
        "holds": holds,
    }
    return {"depth_check": entry, "frame": [args.width, args.height], "seed": args.seed,
            "device": smi}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="adaptive_depth_check",
                                 description=__doc__.split("\n")[0])
    _study.add_common(ap)
    ap.add_argument("--n", type=int, default=20480, help="uniform spp (each of two renders)")
    ap.add_argument("--speedup", type=float, default=2.55,
                    help="claimed time-to-quality speedup: adaptive renders n / speedup spp")
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    ap.add_argument("--spp-step", type=int, default=128)
    args = ap.parse_args(argv)
    out = _study.out_dir(args.out)
    result = run(args)
    _study.write_json(out, "adaptive_depth_check.json", result)
    print(json.dumps(result["depth_check"]))
    e = result["depth_check"]
    return 0 if np.isfinite([e["rmse_uniA_uniB"], e["rmse_ada_uniA"], e["rmse_ada_uniB"]]).all() \
        else 1


if __name__ == "__main__":
    sys.exit(main())
