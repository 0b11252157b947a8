"""Scene-size scaling: K3's ms a sample against the object count.

Counterpart of ``scripts/scene_scale_bench.py``.  Per object count
(``core/scene.grid_scene`` spheres plus the floor disc; 6, 12, 24, 48 and
96 by default) and per NIF chain (bf16, int8, tf32), with the trained NIF
env ``assets/nif_w192e16`` through the production ``render_step`` (the
fused megastep, K3) at 1104x1000 and 300 spp a step:

  * the first step's seconds (host clock, synchronised): the JAX script's
    "compile seconds" have no counterpart here - K3 is built once (the
    first count's first step of each chain includes the build) and a
    scene's tables are runtime data, copied once;
  * the steady ms a sample (CUDA events) over enough steps to fill
    ``--min-seconds`` (5), and the Mpaths/s it makes;
  * K3's shared-memory plan for the scene (``ops/megastep.megastep_wg_plan``:
    the chain's ring stages after the scene's tables).

    python3 -m ipu_path_trace_tpu_torch.probes.scene_scale_bench --out DIR [N ...] \\
        [--chains bf16,int8,tf32] [--width 1104 --height 1000] \\
        [--spp 300] [--min-seconds 5] [--device cuda|cpu]

writes ``DIR/scene_scale_bench.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import _study

COUNTS = (6, 12, 24, 48, 96)
CHAINS = {"bf16": ("auto", "half"), "int8": ("int8", "half"), "tf32": ("auto", "float")}


def measure(scene, env, cfg, wl, spp: int, min_seconds: float, dev) -> dict:
    """First-step seconds, then ms a sample over at least ``min_seconds``
    (three steps at least) of ``render_step`` at ``spp`` samples."""
    b = _study.base(0, len(scene.colour))
    t0 = time.perf_counter()
    work = _study.uniform_steps(scene, env, cfg, _study.batch(wl, dev), spp,
                                [_study.step_seed(b, 0)])
    _study.sync(dev)
    first_s = time.perf_counter() - t0
    probe = _study.Window(dev)
    with probe:
        work = _study.uniform_steps(scene, env, cfg, work, spp, [_study.step_seed(b, 1)])
    step_s = probe.device if probe.device is not None else probe.wall
    steps = max(3, int(min_seconds / max(step_s, 1e-9)) + 1)
    window = _study.Window(dev)
    with window:
        _study.uniform_steps(scene, env, cfg, work, spp,
                             [_study.step_seed(b, i + 2) for i in range(steps)])
    secs = window.device if window.device is not None else window.wall
    ms = secs / steps / spp * 1e3
    return {"first_step_seconds": round(first_s, 3), "ms_per_sample": ms,
            "mpaths_per_s": cfg.width * cfg.height / ms / 1e3, "steps_timed": steps}


def run(args) -> dict:
    from ..core.records import make_worklist
    from ..core.scene import grid_scene
    from ..ops.megastep import megastep_wg_plan, table_bytes
    from ..render.params import StaticConfig

    dev = _study.device_of(args.device, "scene_scale_bench")
    smi = _study.card(dev)
    cfg = StaticConfig(width=args.width, height=args.height)
    wl = make_worklist(args.width, args.height)  # raster order, as the script
    rows = []
    print(f"device: {smi}, frame {args.width}x{args.height}", file=sys.stderr, flush=True)
    print(f"{'chain':>6} {'objects':>8} {'first_s':>8} {'ms/sample':>10} {'Mpaths/s':>9} "
          f"{'stages':>6}", flush=True)
    for chain in args.chains:
        env = _study.load_env(_study.DEFAULT_ASSETS, dev, *CHAINS[chain])
        for n in args.counts:
            scene = grid_scene(n - 1, device=dev)  # + the floor disc = n objects
            plan = megastep_wg_plan(env.model, scene)
            row = {"chain": chain, "objects": n, "table_bytes": table_bytes(scene),
                   "ring_stages": plan["stages"],
                   **measure(scene, env, cfg, wl, args.spp, args.min_seconds, dev)}
            rows.append(row)
            print(f"{chain:>6} {n:>8} {row['first_step_seconds']:>8.2f} "
                  f"{row['ms_per_sample']:>10.4f} {row['mpaths_per_s']:>9.1f} "
                  f"{row['ring_stages']:>6}", flush=True)
    return {"frame": [args.width, args.height], "spp": args.spp,
            "assets": _study.DEFAULT_ASSETS.name,
            "min_seconds": args.min_seconds, "rows": rows, "device": smi,
            "first_step_note": "K3 is built once, at the first step of the first count of "
                               "each chain; a scene's tables are runtime data (no compile)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scene_scale_bench", description=__doc__.split("\n")[0])
    _study.add_common(ap, assets=False, seed=False)
    ap.add_argument("counts", nargs="*", type=int, default=list(COUNTS))
    ap.add_argument("--chains", default="bf16,int8,tf32",
                    type=lambda s: [c for c in s.split(",") if c])
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    ap.add_argument("--spp", type=int, default=300)
    ap.add_argument("--min-seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not args.counts:
        args.counts = list(COUNTS)
    unknown = [c for c in args.chains if c not in CHAINS]
    if unknown:
        ap.error(f"unknown chains {unknown} (choices: {', '.join(CHAINS)})")
    out = _study.out_dir(args.out)
    result = run(args)
    path = _study.write_json(out, "scene_scale_bench.json", result)
    print(json.dumps({"written": str(path)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
