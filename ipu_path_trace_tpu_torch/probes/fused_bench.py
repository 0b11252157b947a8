"""The fused megastep against the per-sample kernel pair.

Counterpart of ``scripts/fused_bench.py``: ``render_step`` at 1104x1000
with the synthetic 6x320 NIF (``models/nif.make_synthetic_nif(0)``, bf16),
``--loop`` (16) samples a step, fused (K3, one launch) and unfused (K1 +
K2 per sample), each timed with CUDA events over ``--reps`` (3) steps
after a warm one (``utils/devtime.time_per_call``); ms a sample and
Mpaths/s.

    python3 -m ipu_path_trace_tpu_torch.probes.fused_bench --out DIR \\
        [--loop 16] [--reps 3] [--width 1104 --height 1000] [--device cuda|cpu]

writes ``DIR/fused_bench.json``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import _study


def synthetic_env(dev):
    """The scripts' env: the synthetic canonical 6x320 NIF in bf16."""
    from ..models.envlight import NifEnv
    from ..models.nif import make_params, make_synthetic_nif

    weights, meta = make_synthetic_nif(0)
    return NifEnv(model=make_params(weights, meta, torch.bfloat16, dev))


def step_ms(scene, env, cfg, work, loop: int, reps: int, dev) -> float:
    """ms a sample of ``render_step`` at ``loop`` samples a step."""
    from ..render.params import RenderSettings
    from ..render.wavefront import render_step
    from ..utils.devtime import time_per_call

    settings = RenderSettings.make(samples_per_step=loop)
    seed = _study.step_seed(_study.base(0, 5), 0)
    return time_per_call(lambda: render_step(scene, settings, cfg, work, seed, env), reps,
                         dev) / loop * 1e3


def run(args) -> dict:
    from ..core.records import make_worklist
    from ..core.scene import default_scene
    from ..render.params import StaticConfig

    dev = _study.device_of(args.device, "fused_bench")
    smi = _study.card(dev)
    scene, env = default_scene(dev), synthetic_env(dev)
    work = _study.batch(make_worklist(args.width, args.height), dev)
    out = {"frame": [args.width, args.height], "loop": args.loop, "reps": args.reps,
           "ms_per_sample": {}, "mpaths_per_s": {}, "device": smi}
    for fused in (False, True):
        name = "fused" if fused else "unfused"
        cfg = StaticConfig(width=args.width, height=args.height, use_fused_step=fused)
        ms = step_ms(scene, env, cfg, work, args.loop, args.reps, dev)
        out["ms_per_sample"][name] = ms
        out["mpaths_per_s"][name] = args.width * args.height / ms / 1e3
        print(f"fused={fused}: {ms:8.4f} ms/sample ({out['mpaths_per_s'][name]:7.1f} Mpaths/s)"
              f" ({smi})", flush=True)
    out["unfused_over_fused"] = out["ms_per_sample"]["unfused"] / out["ms_per_sample"]["fused"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fused_bench", description=__doc__.split("\n")[0])
    _study.add_common(ap, assets=False, seed=False)
    ap.add_argument("--loop", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    args = ap.parse_args(argv)
    out = _study.out_dir(args.out)
    result = run(args)
    _study.write_json(out, "fused_bench.json", result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
