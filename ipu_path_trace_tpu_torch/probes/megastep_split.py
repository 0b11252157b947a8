"""Where K3's time goes, by its measurement stubs, on each chain.

Counterpart of ``scripts/megastep_split.py``: K3 (``render_megastep``)
at 1104x1000 and ``--loop`` (300) samples a launch, in full and with its
stubs (``csrc/megastep_stub.cu``, the ones ``--device-timing`` runs):
``'trace'`` (every bounce stubbed: the NIF chain alone on zero escapes,
"nif-only"), ``'nif'`` (the chain's products stubbed: "trace-only") and
``'both'`` ("neither"), for each chain (bf16, int8, tf32) of the NIF in
``--assets`` (``assets/procedural_sky_nif``, the canonical 6x320, by
default); ms a sample with CUDA events over ``--reps`` (2) launches after
a warm one.

    python3 -m ipu_path_trace_tpu_torch.probes.megastep_split --out DIR \\
        [--assets DIR] [--chains bf16,int8,tf32] [--loop 300] [--reps 2] \\
        [--width 1104 --height 1000] [--device cuda|cpu]

writes ``DIR/megastep_split.json``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import _study
from .scene_scale_bench import CHAINS

VARIANTS = (("full", None), ("nif-only", "trace"), ("trace-only", "nif"), ("neither", "both"))


def run(args) -> dict:
    from ..core.records import make_worklist
    from ..core.scene import default_scene
    from ..ops.megastep import render_megastep
    from ..render.params import RenderSettings
    from ..utils.devtime import time_per_call

    dev = _study.device_of(args.device, "megastep_split")
    smi = _study.card(dev)
    scene = default_scene(dev)
    w, h = args.width, args.height
    work = _study.batch(make_worklist(w, h), dev)
    cols, rows = work.u.to(torch.float32), work.v.to(torch.float32)
    settings = RenderSettings.make(samples_per_step=args.loop)
    out = {"frame": [w, h], "loop": args.loop, "reps": args.reps, "assets": str(args.assets),
           "ms_per_sample": {}, "device": smi}
    for chain in args.chains:
        model = _study.load_env(args.assets, dev, *CHAINS[chain]).model
        out["ms_per_sample"][chain] = {}
        for name, stub in VARIANTS:
            i = iter(range(1 << 30))
            fn = lambda s=stub: render_megastep(  # noqa: E731
                scene, settings, model, cols, rows, (next(i), 3), width=w, height=h,
                max_path_length=10, stub=s)
            ms = time_per_call(fn, args.reps, dev) / args.loop * 1e3
            out["ms_per_sample"][chain][name] = ms
            print(f"{chain:5s} {name:12s} {ms:8.4f} ms/sample ({w * h / ms / 1e3:7.1f} Mpaths/s)"
                  f" ({smi})", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="megastep_split", description=__doc__.split("\n")[0])
    _study.add_common(ap, assets=False, seed=False)
    ap.add_argument("--assets", default=str(_study.ROOT / "assets" / "procedural_sky_nif"))
    ap.add_argument("--chains", default="bf16,int8,tf32",
                    type=lambda s: [c for c in s.split(",") if c])
    ap.add_argument("--loop", type=int, default=300)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    args = ap.parse_args(argv)
    out = _study.out_dir(args.out)
    result = run(args)
    _study.write_json(out, "megastep_split.json", result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
