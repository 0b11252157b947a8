"""The adaptive sampler's equal-cost quality win.

Counterpart of ``scripts/adaptive_bench.py``.  Protocol (1104x1000,
trained NIF env ``assets/nif_w192e16``, the coherent worklist):

  1. ground truth: a uniform render at ``--gt-spp`` (16384) samples a pixel;
  2. the frame rendered twice at equal per-step sample totals, once with
     the uniform sampler (``render/wavefront.render_step``) and once with
     ``--adaptive``'s controller (``render/adaptive.adaptive_render_step``),
     ``--spp-step`` (128) samples a step, the RMSE of the running per-pixel
     mean against the ground truth at 1, 2, 4, 8 and 16 steps, and each
     curve's time (probes/_study.py: wall and CUDA events).

Both samplers run the same fused megastep (K3) at the same total, so a
gap at a checkpoint is the allocation's alone; ``sample_efficiency`` is
(rmse_u / rmse_a)^2, the factor by which the uniform curve must run
longer to match.  ``time_to_quality_speedup`` is the wall time the
uniform sampler needs for the adaptive curve's final RMSE (rmse ~ c /
sqrt(n), fitted at its last point) over the adaptive curve's.

    python3 -m ipu_path_trace_tpu_torch.probes.adaptive_bench --out DIR \\
        [assets] [--width 1104 --height 1000 --gt-spp 16384 --spp-step 128] \\
        [--check-steps 1,2,4,8,16] [--seed 0] [--device cuda|cpu]

writes ``DIR/adaptive_bench.json`` with the keys of the JAX record
(``docs/ADAPTIVE.json``, a TPU run: its seconds are not the port's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from . import _study

CHECK_STEPS = (1, 2, 4, 8, 16)  # totals 128 .. 2048 spp-equivalent


def time_to_quality_speedup(uni: list[dict], ada: list[dict], key: str = "seconds") -> float:
    """Time for the uniform sampler to reach the adaptive curve's final
    RMSE, by rmse ~ c / sqrt(n) fitted at the uniform curve's last point,
    over the adaptive curve's time (scripts/adaptive_bench.py:150-157)."""
    n_match = uni[-1]["total_spp"] * (uni[-1]["rmse"] / ada[-1]["rmse"]) ** 2
    t_match = uni[-1][key] * n_match / uni[-1]["total_spp"]
    return round(t_match / ada[-1][key], 2)


def final_budgets(work, lum2, cfg, spp_step: int) -> dict:
    """Where the samples went: the controller's next budgets
    (``compute_budgets`` at ops/megastep.BUDGET_BLOCK) by share at the
    floor and at the cap, and their mean."""
    from ..ops.megastep import BUDGET_BLOCK
    from ..render.adaptive import adaptive_caps, compute_budgets

    lo, cap = adaptive_caps(cfg, spp_step)
    buds = compute_budgets(work.r, work.g, work.b, lum2, work.sample_count,
                           block_size=BUDGET_BLOCK, samples_per_step=spp_step, min_spp=lo,
                           max_spp=cap).cpu().numpy()
    return {"floor_fraction": float((buds == lo).mean()),
            "cap_fraction": float((buds == cap).mean()), "mean": float(buds.mean())}


def run(args) -> dict:
    from ..core.scene import default_scene
    from ..render.params import StaticConfig

    dev = _study.device_of(args.device, "adaptive_bench")
    env = _study.load_env(args.assets, dev)
    scene = default_scene(dev)
    cfg = StaticConfig(width=args.width, height=args.height)
    smi = _study.card(dev)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(f"device: {smi}, frame {args.width}x{args.height}, assets {args.assets}")
    wl, mask = _study.coherent_worklist(scene, args.width, args.height)
    gt, gt_s = _study.ground_truth(scene, env, cfg, wl, mask, args.gt_spp, args.seed, dev)
    log(f"ground truth {args.gt_spp} spp in {gt_s:.1f} s")
    curve = lambda adaptive, label: _study.run_curve(  # noqa: E731
        scene, env, cfg, wl, mask, gt, args.spp_step, args.check_steps, args.seed, dev,
        adaptive, label, log)
    uni, _, _ = curve(False, "uniform")
    ada, work_a, lum2_a = curve(True, "adaptive")
    counts = work_a.sample_count.cpu().numpy()[mask]
    device_speedup = (None if ada[-1]["device_seconds"] is None else
                      time_to_quality_speedup(uni, ada, "device_seconds"))
    return {
        "frame": [args.width, args.height], "assets": os.path.basename(args.assets.rstrip("/")),
        "gt_spp": args.gt_spp, "spp_per_step": args.spp_step,
        "adaptive_min": cfg.adaptive_min, "adaptive_max_factor": cfg.adaptive_max_factor,
        "uniform": uni, "adaptive": ada,
        "sample_efficiency": _study.sample_efficiency(uni, ada),
        "time_to_quality_speedup": time_to_quality_speedup(uni, ada),
        "time_to_quality_speedup_device": device_speedup,
        "final_budgets": final_budgets(work_a, lum2_a, cfg, args.spp_step),
        "final_counts": {"min": int(counts.min()), "max": int(counts.max()),
                         "mean": round(float(counts.mean()), 1)},
        "seed": args.seed, "ground_truth_seconds": round(gt_s, 3), "device": smi,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="adaptive_bench", description=__doc__.split("\n")[0])
    _study.add_common(ap)
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    ap.add_argument("--gt-spp", type=int, default=16384)
    ap.add_argument("--spp-step", type=int, default=128)
    _study.add_check_steps(ap, CHECK_STEPS)
    args = ap.parse_args(argv)
    out = _study.out_dir(args.out)
    result = run(args)
    path = _study.write_json(out, "adaptive_bench.json", result)
    print(json.dumps({"sample_efficiency_at_checkpoints": result["sample_efficiency"],
                      "time_to_quality_speedup": result["time_to_quality_speedup"],
                      "written": str(path)}))
    return 0 if np.isfinite([p["rmse"] for p in result["uniform"] + result["adaptive"]]).all() \
        else 1


if __name__ == "__main__":
    sys.exit(main())
