"""NIF width sweep: train, score and bench hidden widths on the card.

Port of ``scripts/nif_width_sweep.py``: for each width (default 256, 320
and 384; ``--archs`` adds per-layer width lists) train a NIF on
``assets/procedural_sky.exr`` with the same recipe (models/train_nif.py),
score the reconstruction of the source (models/reconstruct.py: K4 on the
card) with the log-radiance PSNR (probes/quant_psnr.psnr_log), and bench
the fused render step (K3) at the canonical 1104x1000 / 300-spp shape,
ms per sample by CUDA events.  Widths 321-384 run their hidden layers in
two passes in the bf16 chain (csrc/nif_wgmma.cuh).  ``--eval-assets``
scores and benches trained asset directories instead of training.

    python -m ipu_path_trace_tpu_torch.tools.nif_width_sweep --out DIR [--epochs 300] \\
        [--widths 256 320 384] [--archs 256-128-208-256-128-128 ...] [--eval-assets DIR ...] \\
        [--layer-count 6] [--embedding-dim 12] [--batch-size 65536] [--cosine-decay] \\
        [--skip-bench] [--device cuda|cpu]

writes ``DIR/nif_widths.json`` and each trained asset but the canonical
6x320 E=12 as ``DIR/nif_w<width>`` (``nif_m<widths>``, ``nif_l<L>w<width>``,
``e<E>`` appended as the script names them); never ``docs/NIF_WIDTHS.json``
or ``assets/``.  The bench needs CUDA (``--skip-bench`` on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "assets" / "procedural_sky.exr"
WIDTH, HEIGHT = 1104, 1000
SPP = 300


def bench_width(model, device) -> float:
    """ms per sample of the fused render step (K3) at the canonical
    1104x1000 shape, SPP samples a launch, CUDA events over 3 launches
    after a warm-up."""
    from ..core.records import make_worklist, to_device_batch
    from ..core.scene import default_scene
    from ..models.envlight import NifEnv
    from ..render.params import RenderSettings, StaticConfig
    from ..render.wavefront import render_step
    from ..utils.devtime import time_per_call

    dev = torch.device(device)
    if dev.type != "cuda":
        raise SystemExit("nif_width_sweep: the bench times K3 on the card; pass --skip-bench "
                         "on the CPU")
    scene = default_scene(dev)
    env = NifEnv(model=model)
    cfg = StaticConfig(width=WIDTH, height=HEIGHT)
    settings = RenderSettings.make(samples_per_step=SPP)
    work = to_device_batch(make_worklist(WIDTH, HEIGHT), dev)
    return time_per_call(lambda: render_step(scene, settings, cfg, work, (1, 2), env), 3,
                         dev) * 1e3 / SPP


def arch_tag(spec, layer_count: int, embed: int) -> str:
    """The asset name the script gives a trained spec."""
    if isinstance(spec, int):
        tag = f"nif_w{spec}" if layer_count == 6 else f"nif_l{layer_count}w{spec}"
    else:
        tag = "nif_m" + "-".join(str(w) for w in spec)
    return tag + (f"e{embed}" if embed != 12 else "")


def _entry(spec, layers, loss, q, ms, params_kib, epochs, cosine, embed, **extra) -> dict:
    entry = {"width": spec if isinstance(spec, int) else "-".join(str(w) for w in spec),
             "layers": layers, "final_loss": loss, "psnr_log_db": round(q, 2),
             "ms_per_sample": None if ms is None else round(ms, 3),
             "mpaths_per_sec": None if ms is None else round(WIDTH * HEIGHT / ms / 1e3, 1),
             "params_kib": round(params_kib, 1), "epochs": epochs, "cosine_decay": cosine,
             **extra}
    if embed != 12:
        entry["embedding_dim"] = embed
    return entry


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nif_width_sweep")
    p.add_argument("--out", required=True, help="directory for nif_widths.json and the assets")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--widths", type=int, nargs="*", default=[256, 320, 384])
    p.add_argument("--archs", type=str, nargs="*", default=[],
                   help="mixed-width archs as dash-separated per-layer widths, e.g. "
                        "256-128-208-256-128-128")
    p.add_argument("--skip-bench", action="store_true")
    p.add_argument("--eval-assets", type=str, nargs="*", default=[],
                   help="no training: PSNR + bench of trained asset dirs (a path, or a name "
                        "under assets/)")
    p.add_argument("--cosine-decay", action="store_true")
    p.add_argument("--layer-count", type=int, default=6,
                   help="hidden layers (6 = canonical); the skip concat sits at layer_count//2")
    p.add_argument("--embedding-dim", type=int, default=12, help="Fourier embedding dim E")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    from ..film.imageio import read_exr
    from ..models.nif import analyse_nif, load_nif_assets, make_params
    from ..models.reconstruct import reconstruct_image
    from ..models.train_nif import check_device, save_assets, train_nif
    from ..probes.quant_psnr import psnr_log

    dev = check_device(args.device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    src = read_exr(str(SOURCE))
    h, w = src.shape[:2]
    print(f"source HDRI {w}x{h}, device {dev}", file=sys.stderr)

    def bench(model):
        return None if args.skip_bench else bench_width(model, dev)

    results = []
    for name in args.eval_assets:
        path = name if os.path.isdir(name) else str(ROOT / "assets" / name)
        model, meta, weights = load_nif_assets(path, torch.bfloat16, dev)
        widths = [l.kernel.shape[1] for l in weights.layers[:-1]]
        spec = widths[0] if len(set(widths)) == 1 else tuple(widths)
        q = psnr_log(reconstruct_image(model, h, w), src)
        results.append(_entry(spec, len(widths), None, q, bench(model),
                              analyse_nif(weights, 1)["parameters_kib"], args.epochs,
                              args.cosine_decay, meta.embedding_dimension,
                              note=f"evaluated from {path}"))
        print(json.dumps(results[-1]), flush=True)

    specs = [] if args.eval_assets else list(args.widths) + [
        tuple(int(t) for t in a.split("-")) for a in args.archs]
    for spec in specs:
        mixed = not isinstance(spec, int)
        layer_count = len(spec) if mixed else args.layer_count
        t0 = time.monotonic()
        weights, meta, loss = train_nif(
            src, layer_size=list(spec) if mixed else spec, layer_count=layer_count,
            skip_layer=layer_count // 2, epochs=args.epochs, batch_size=args.batch_size,
            cosine_decay=args.cosine_decay, embedding_dim=args.embedding_dim, seed=0,
            name=str(SOURCE), device=dev)
        train_s = time.monotonic() - t0
        if not (spec == 320 and layer_count == 6 and args.embedding_dim == 12):
            size_args = (["--layer-sizes", ",".join(str(x) for x in spec)] if mixed
                         else ["--layer-size", str(spec)])
            tag = arch_tag(spec, layer_count, args.embedding_dim)
            save_assets(str(out / tag), weights, meta, [
                "python", "-m", "ipu_path_trace_tpu_torch.models.train_nif",
                "assets/procedural_sky.exr", tag, "--layer-count", str(layer_count), *size_args,
                "--skip-layer", str(layer_count // 2),
                "--embedding-dimension", str(args.embedding_dim), "--epochs", str(args.epochs),
                "--batch-size", str(args.batch_size),
                *(["--cosine-decay"] if args.cosine_decay else [])])
        model = make_params(weights, meta, torch.bfloat16, dev)
        q = psnr_log(reconstruct_image(model, h, w), src)
        results.append(_entry(spec, layer_count, loss, q, bench(model),
                              analyse_nif(weights, 1)["parameters_kib"], args.epochs,
                              args.cosine_decay, args.embedding_dim,
                              train_seconds=round(train_s, 1)))
        print(json.dumps(results[-1]), flush=True)
        (out / "nif_widths.json").write_text(json.dumps(  # survives a crash mid-sweep
            {"procedural_sky": results, "device": card}, indent=2))
    (out / "nif_widths.json").write_text(json.dumps(
        {"procedural_sky": results, "device": card}, indent=2))
    print(f"wrote {out / 'nif_widths.json'}", file=sys.stderr)
    return 0 if all(np.isfinite(e["psnr_log_db"]) for e in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
