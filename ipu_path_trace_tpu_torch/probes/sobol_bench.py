"""``--sampler sobol``: RMSE against samples, its rate cost, its consistency.

Counterpart of ``scripts/sobol_bench.py``.  Protocol (1104x1000, trained
NIF env ``assets/nif_w192e16``, the coherent worklist):

  1. ground truth: a Philox render at ``--gt-spp`` (16384) samples a pixel,
     on streams independent of every compared curve (probes/_study.py);
  2. equal-spp RMSE curves against it for {prng, sobol} x {uniform,
     adaptive}: the same fused megastep (K3) at the same totals, so a gap
     is the sampler's or the allocation's alone;
  3. the rate cost of the in-kernel Owen-Sobol bits at 300 spp a step
     (CUDA events, after a warm step);
  4. consistency of the in-kernel Sobol render: the script held it
     against the same kernel on host-computed points; the port holds it
     by ``probes/validate_gpu.check`` (fused Sobol K3 against host-noise
     unfused renders, ``cross < 1.5 floor + 1e-4``) at its own size,
     128x128 @ 256 spp (``--check-size``, ``--check-spp``).

    python3 -m ipu_path_trace_tpu_torch.probes.sobol_bench --out DIR [assets] \\
        [--width 1104 --height 1000 --gt-spp 16384 --spp-step 128] \\
        [--rate-spp 300 --rate-steps 4] [--check-size 128x128 --check-spp 256] \\
        [--check-steps 1,2,4,8,16] [--seed 0] [--device cuda|cpu]

writes ``DIR/sobol_bench.json`` with the keys of the JAX record
(``docs/SOBOL.json``, a TPU run: its seconds and rates are not the port's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from . import _study

CHECK_STEPS = (1, 2, 4, 8, 16)
CURVES = (("prng_uniform", "prng", False), ("sobol_uniform", "sobol", False),
          ("prng_adaptive", "prng", True), ("sobol_adaptive", "sobol", True))


def rates(scene, env, cfgs: dict, wl, spp: int, steps: int, seed: int, dev) -> dict:
    """Mpaths/s and ms a sample of each sampler's uniform step at ``spp``
    samples, over ``steps`` steps after a warm one (CUDA events on the
    card, the host clock for the plain versions)."""
    out = {}
    b = _study.base(seed, 1)
    for name, cfg in cfgs.items():
        work = _study.uniform_steps(scene, env, cfg, _study.batch(wl, dev), spp,
                                    [_study.step_seed(b, 0)])
        window = _study.Window(dev)
        with window:
            _study.uniform_steps(scene, env, cfg, work, spp,
                                 [_study.step_seed(b, s + 1) for s in range(steps)])
        secs = window.device if window.device is not None else window.wall
        n = int(wl.shape[0])
        out[name] = {"mpaths_per_s": n * spp * steps / secs / 1e6,
                     "ms_per_sample": secs / (spp * steps) * 1e3}
    return out


def consistency(env, scene, size: tuple[int, int], spp: int, dev) -> dict:
    """probes/validate_gpu.check of the fused Sobol render against the
    host-noise unfused one (Philox from generators seeded 1 and 2)."""
    from .validate_gpu import check, render

    w, h = size
    res = check(f"sobol fused vs host-noise unfused {w}x{h} @ {spp} spp",
                lambda s: render(env, scene, w, h, spp, s, host_noise=True, fused=False,
                                 device=dev),
                lambda s: render(env, scene, w, h, spp, s, host_noise=False, fused=True,
                                 sampler="sobol", device=dev))
    return {"frame": [w, h], "spp": spp, "floor": res["floor"], "cross": res["cross"],
            "pass": res["pass"], "check": "probes/validate_gpu.check"}


def run(args) -> dict:
    from ..core.scene import default_scene
    from ..render.params import StaticConfig

    dev = _study.device_of(args.device, "sobol_bench")
    env = _study.load_env(args.assets, dev)
    scene = default_scene(dev)
    cfgs = {"prng": StaticConfig(width=args.width, height=args.height),
            "sobol": StaticConfig(width=args.width, height=args.height, sampler="sobol")}
    smi = _study.card(dev)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(f"device: {smi}, frame {args.width}x{args.height}, assets {args.assets}")
    wl, mask = _study.coherent_worklist(scene, args.width, args.height)
    gt, gt_s = _study.ground_truth(scene, env, cfgs["prng"], wl, mask, args.gt_spp, args.seed,
                                   dev)
    log(f"ground truth {args.gt_spp} spp in {gt_s:.1f} s")
    curves = {}
    for name, sampler, adaptive in CURVES:
        curves[name] = _study.run_curve(scene, env, cfgs[sampler], wl, mask, gt, args.spp_step,
                                        args.check_steps, args.seed, dev, adaptive, name, log)[0]
    rate = rates(scene, env, cfgs, wl, args.rate_spp, args.rate_steps, args.seed, dev)
    for k, v in rate.items():
        log(f"rate[{k}]: {v['mpaths_per_s']:.1f} Mpaths/s ({v['ms_per_sample']:.4f} ms a sample)")
    effs = {k: _study.sample_efficiency(curves["prng_uniform"], curves[k])
            for k in ("sobol_uniform", "prng_adaptive", "sobol_adaptive")}
    return {
        "frame": [args.width, args.height], "assets": os.path.basename(args.assets.rstrip("/")),
        "gt_spp": args.gt_spp, "spp_per_step": args.spp_step,
        "curves": curves,
        "sample_efficiency_vs_prng_uniform": effs,
        # The JAX record's key; the samples a step are "rate_spp" (300 by default).
        "rates_mpaths_300spp": {k: round(v["mpaths_per_s"], 1) for k, v in rate.items()},
        "ms_per_sample_rate": {k: v["ms_per_sample"] for k, v in rate.items()},
        "rate_spp": args.rate_spp,
        "sobol_rate_cost": rate["prng"]["mpaths_per_s"] / rate["sobol"]["mpaths_per_s"],
        "hw_vs_host_consistency": consistency(env, scene, args.check_size, args.check_spp, dev),
        "seed": args.seed, "ground_truth_seconds": round(gt_s, 3), "device": smi,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sobol_bench", description=__doc__.split("\n")[0])
    _study.add_common(ap)
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    ap.add_argument("--gt-spp", type=int, default=16384)
    ap.add_argument("--spp-step", type=int, default=128)
    ap.add_argument("--rate-spp", type=int, default=300)
    ap.add_argument("--rate-steps", type=int, default=4)
    ap.add_argument("--check-size", default="128x128",
                    type=lambda s: tuple(int(x) for x in s.split("x")))
    ap.add_argument("--check-spp", type=int, default=256)
    _study.add_check_steps(ap, CHECK_STEPS)
    args = ap.parse_args(argv)
    out = _study.out_dir(args.out)
    result = run(args)
    path = _study.write_json(out, "sobol_bench.json", result)
    print(json.dumps({"sample_efficiency": result["sample_efficiency_vs_prng_uniform"],
                      "rates": result["rates_mpaths_300spp"],
                      "written": str(path)}))
    finite = np.isfinite([p["rmse"] for c in result["curves"].values() for p in c]).all()
    return 0 if finite and result["hw_vs_host_consistency"]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
