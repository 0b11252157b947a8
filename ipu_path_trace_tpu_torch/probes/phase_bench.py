"""Per-phase device time: K1 and K2 alone, beside the fused step.

Counterpart of ``scripts/phase_bench.py``, the analog of the reference's
per-phase cycle counters, at 1104x1000 with the synthetic 6x320 NIF:
K1 (the trace) in a loop of ``--loop`` (16) samples, K2 (the env shade)
in a loop of as many launches over one sample's escapes - both from
``utils/devtime.measure_phases`` on the unfused path, which the CLI's
``--device-timing`` runs - and the fused step (K3) at ``--loop`` samples;
each with CUDA events over ``--reps`` (3) repetitions after a warm one.
The glue is the fused step less the two phases.

    python3 -m ipu_path_trace_tpu_torch.probes.phase_bench --out DIR \\
        [--loop 16] [--reps 3] [--width 1104 --height 1000] [--device cuda|cpu]

writes ``DIR/phase_bench.json``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import _study
from .fused_bench import step_ms, synthetic_env


def run(args) -> dict:
    from ..core.records import make_worklist
    from ..core.scene import default_scene
    from ..ops.trace import trace_sample
    from ..render.params import RenderSettings, StaticConfig
    from ..utils.devtime import measure_phases

    dev = _study.device_of(args.device, "phase_bench")
    smi = _study.card(dev)
    scene, env = default_scene(dev), synthetic_env(dev)
    w, h = args.width, args.height
    work = _study.batch(make_worklist(w, h), dev)
    settings = RenderSettings.make(samples_per_step=args.loop)
    seed = _study.step_seed(_study.base(0, 3), 0)
    unfused = StaticConfig(width=w, height=h, use_fused_step=False)
    split = measure_phases(scene, settings, unfused, work, seed, env, loop=args.loop,
                           reps=args.reps)
    st = trace_sample(scene, settings, work.u.to(torch.float32), work.v.to(torch.float32),
                      seed, width=w, height=h, max_path_length=unfused.max_path_length)
    escaped = float(st.escaped.float().mean())
    full = step_ms(scene, env, StaticConfig(width=w, height=h), work, args.loop, args.reps, dev)
    out = {"frame": [w, h], "loop": args.loop, "reps": args.reps,
           "escaped_fraction": escaped,
           "ms_per_sample": {"trace": split["trace_ms"], "env_shade": split["env_ms"],
                             "sum": split["trace_ms"] + split["env_ms"],
                             "unfused_step": split["step_ms"], "fused_step": full,
                             "glue": full - split["trace_ms"] - split["env_ms"]},
           "device": smi}
    for k, v in out["ms_per_sample"].items():
        print(f"{k:14s} {v:9.4f} ms/sample ({w * h / v / 1e3:8.1f} Mpaths/s) ({smi})",
              flush=True)
    print(f"escaped fraction at terminal: {escaped:.3f}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phase_bench", description=__doc__.split("\n")[0])
    _study.add_common(ap, assets=False, seed=False)
    ap.add_argument("--loop", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    args = ap.parse_args(argv)
    out = _study.out_dir(args.out)
    result = run(args)
    _study.write_json(out, "phase_bench.json", result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
