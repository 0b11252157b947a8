"""The per-step worklist round trip between host and card, against device time.

Counterpart of ``scripts/host_roundtrip_bench.py``.  With the host film a
step uploads the worklist, renders it and downloads it back (the
reference's loop, 20 bytes a pixel each way); with ``--device-film`` the
worklist stays on the card and a step is the render alone.  At 8 spp a
step (interactive) and 300 (the canonical step), with the synthetic
6x320 NIF through ``render_step`` (K3):

  * ``host_film_step_ms``: upload + render + download, host clock, over
    10 steps at 8 spp and 3 at 300 (``--steps``) after a warm one;
  * ``device_film_step_ms``: the render chained on the card, synchronised
    once at the end (host clock), and ``device_ms`` the same window by
    CUDA events;
  * ``upload_ms`` and ``download_ms`` alone (host clock, synchronised),
    and the round trip's share of the host-film step.

    python3 -m ipu_path_trace_tpu_torch.probes.host_roundtrip_bench --out DIR \\
        [--size 512x512] [--steps 8:10,300:3] [--device cuda|cpu]

writes ``DIR/host_roundtrip_bench.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import _study
from .fused_bench import synthetic_env

STEPS = ((8, 10), (300, 3))  # (spp a step, repetitions)


def host_ms(fn, reps: int, dev) -> float:
    """ms a call of ``fn`` on the host clock, synchronised before and after."""
    _study.sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _study.sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def run(args) -> dict:
    from ..core.records import from_device_batch, make_worklist, to_device_batch
    from ..core.scene import default_scene
    from ..render.params import RenderSettings, StaticConfig
    from ..render.wavefront import render_step

    dev = _study.device_of(args.device, "host_roundtrip_bench")
    smi = _study.card(dev)
    w, h = args.size
    scene, env = default_scene(dev), synthetic_env(dev)
    cfg = StaticConfig(width=w, height=h)
    records = make_worklist(w, h)
    seed = _study.step_seed(_study.base(0, 0), 0)
    rows = []
    for spp, reps in args.steps:
        settings = RenderSettings.make(samples_per_step=spp)
        wd = to_device_batch(records, dev)
        out = render_step(scene, settings, cfg, wd, seed, env)  # warm-up, the build
        from_device_batch(out)

        def host_film_step():
            from_device_batch(render_step(scene, settings, cfg, to_device_batch(records, dev),
                                          seed, env))

        host_film = host_ms(host_film_step, reps, dev)
        window = _study.Window(dev)
        out = wd
        with window:
            for _ in range(reps):
                out = render_step(scene, settings, cfg, out, seed, env)
        upload = host_ms(lambda: to_device_batch(records, dev), reps, dev)
        download = host_ms(lambda: from_device_batch(out), reps, dev)
        row = {"spp": spp, "reps": reps, "host_film_step_ms": host_film,
               "device_film_step_ms": window.wall / reps * 1e3,
               "device_ms": None if window.device is None else window.device / reps * 1e3,
               "upload_ms": upload, "download_ms": download,
               "roundtrip_share_of_host_film_step": (upload + download) / host_film}
        rows.append(row)
        print(f"spp={spp:4d}: host film step {host_film:8.2f} ms | device film step "
              f"{row['device_film_step_ms']:8.2f} ms | upload {upload:6.2f} ms, download "
              f"{download:6.2f} ms: {100 * row['roundtrip_share_of_host_film_step']:5.1f}% of "
              f"the host-film step ({smi})", flush=True)
    return {"frame": [w, h], "bytes_each_way": int(records.nbytes), "rows": rows, "device": smi}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="host_roundtrip_bench", description=__doc__.split("\n")[0])
    _study.add_common(ap, assets=False, seed=False)
    ap.add_argument("--size", default="512x512",
                    type=lambda s: tuple(int(x) for x in s.split("x")))
    ap.add_argument("--steps", default=STEPS,
                    type=lambda s: tuple(tuple(int(x) for x in p.split(":"))
                                         for p in s.split(",")),
                    help="spp:reps pairs (default 8:10,300:3)")
    args = ap.parse_args(argv)
    out = _study.out_dir(args.out)
    result = run(args)
    _study.write_json(out, "host_roundtrip_bench.json", result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
