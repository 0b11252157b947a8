"""Reference-scale NIF sweep: the width rule on-class and at scale, on the card.

Port of ``scripts/nif_reference_scale.py``:

1. generate the deterministic synthetic urban-alley env (models/synth_env.py;
   ``--env``, by default the reference's 2048x4096 ``SYNTH``);
2. train each candidate architecture (default 320, 256, 192, 192e16) with
   the matched recipe (6000 epochs, batch 65,536, 2 steps an epoch, cosine
   decay, seed 0; models/train_nif.py on the card);
3. score the reconstruction of the full frame (K4) with the log-radiance
   PSNR (probes/quant_psnr.psnr_log);
4. measure each architecture's fused render rate (K3 at 1104x1000, 300
   spp: tools/nif_width_sweep.bench_width) in this run, on this card - the
   script's KNOWN_MPATHS were the TPU's rates and are not carried over;
5. apply the decision rule: ship the canonical 6x320 and, if a faster
   architecture scores at least the canonical's PSNR on this content, the
   fastest such one as ``urban_alley_synth_tuned``.

    python -m ipu_path_trace_tpu_torch.tools.nif_reference_scale --out DIR [--epochs 6000] \\
        [--archs 320 256 192 192e16] [--batch-size 65536] [--env synth:urban-alley:HxW:seedN] \\
        [--no-ship] [--no-bench] [--device cuda|cpu]

writes ``DIR/nif_reference_scale.json`` (after every architecture) and the
shipped assets under ``DIR`` (never ``docs/NIF_WIDTHS.json`` or ``assets/``).
Without the bench (``--no-bench``, or on the CPU) the rule has no rates
and ships the canonical asset only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

SYNTH = "synth:urban-alley:2048x4096:seed7"
WIDTH, HEIGHT = 1104, 1000  # the bench's frame (nif_width_sweep.bench_width)


def parse_arch(token: str) -> tuple[int, int, int]:
    """'192' -> (192, 12, 6); '192e16' -> (192, 16, 6);
    '256x8' -> (256, 12, 8) (width x hidden-layer-count)."""
    embed, layers = 12, 6
    if "e" in token:
        token, e = token.split("e")
        embed = int(e)
    if "x" in token:
        token, l = token.split("x")
        layers = int(l)
    return int(token), embed, layers


def train_one(src: np.ndarray, width: int, embed: int, layers: int, epochs: int,
              batch_size: int, name: str = SYNTH, device="cuda"):
    """The matched recipe: cosine decay, seed 0, 2 optimizer steps an
    epoch whatever the image size (12k steps at 6000 epochs)."""
    from ..models.train_nif import train_nif

    return train_nif(src, layer_size=width, layer_count=layers, skip_layer=layers // 2,
                     epochs=epochs, batch_size=batch_size, cosine_decay=True, seed=0,
                     embedding_dim=embed, train_samples=2 * batch_size, name=name,
                     device=device)


def score(weights, meta, src: np.ndarray, device) -> float:
    """Log-radiance PSNR of the bf16 reconstruction (K4 on the card)."""
    from ..models.nif import make_params
    from ..models.reconstruct import reconstruct_image
    from ..probes.quant_psnr import psnr_log

    model = make_params(weights, meta, torch.bfloat16, device)
    return psnr_log(reconstruct_image(model, *src.shape[:2]), src)


def ship(out: Path, weights, meta, out_name: str, arch: str, epochs: int, batch_size: int,
         env: str) -> None:
    """Save a shipped asset with a replayable train_command."""
    from ..models.train_nif import save_assets

    width, embed, layers = parse_arch(arch)
    save_assets(str(out / out_name), weights, meta, [
        "python", "-m", "ipu_path_trace_tpu_torch.models.train_nif", env, out_name,
        "--layer-count", str(layers), "--layer-size", str(width),
        "--embedding-dimension", str(embed), "--skip-layer", str(layers // 2),
        "--epochs", str(epochs), "--batch-size", str(batch_size),
        "--train-samples", str(2 * batch_size), "--learning-rate", "0.001", "--seed", "0",
        "--cosine-decay"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nif_reference_scale")
    p.add_argument("--out", required=True,
                   help="directory for nif_reference_scale.json and the shipped assets")
    p.add_argument("--epochs", type=int, default=6000)
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--archs", nargs="*", default=["320", "256", "192", "192e16"])
    p.add_argument("--env", default=SYNTH, help="a synth:urban-alley:<H>x<W>:seed<N> pseudo-path")
    p.add_argument("--no-ship", action="store_true")
    p.add_argument("--no-bench", action="store_true",
                   help="skip the render rate measurement per arch")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    from ..models.synth_env import resolve_synth
    from ..models.train_nif import check_device
    from .nif_width_sweep import bench_width

    dev = check_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    src = resolve_synth(args.env)
    if src is None:
        raise SystemExit(f"nif_reference_scale: --env must be a synth: pseudo-path, "
                         f"got {args.env!r}")
    h, w = src.shape[:2]
    print(f"urban env {w}x{h} generated in {time.monotonic() - t0:.0f}s, dyn range "
          f"{src.min():.3g}..{src.max():.3g}", file=sys.stderr)
    bench = not args.no_bench and dev.type == "cuda"
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    trained, entries, rate, psnr = {}, [], {}, {}
    section = f"urban_alley_synth_{h}x{w}"  # the script's section at its 2048x4096
    doc = {section: {"description": f"deterministic synthetic urban-alley env ({args.env}; "
                                    "models/synth_env.py); matched recipe; PSNR at the full "
                                    "frame; render rates (K3) measured on this card",
                     "env": args.env, "epochs": args.epochs, "device": card, "results": entries}}
    for arch in args.archs:
        width, embed, layers = parse_arch(arch)
        t0 = time.monotonic()
        weights, meta, loss = train_one(src, width, embed, layers, args.epochs, args.batch_size,
                                        args.env, dev)
        train_s = time.monotonic() - t0
        psnr[arch] = round(score(weights, meta, src, dev), 2)  # the rule compares these
        entry = {"width": width, "psnr_log_db": psnr[arch], "final_loss": loss,
                 "train_seconds": round(train_s, 1)}
        if embed != 12:
            entry["embedding_dim"] = embed
        if layers != 6:
            entry["layers"] = layers
        if bench:
            from ..models.nif import make_params

            ms = bench_width(make_params(weights, meta, torch.bfloat16, dev), dev)
            entry["ms_per_sample"] = round(ms, 3)
            entry["mpaths_per_sec"] = rate[arch] = round(WIDTH * HEIGHT / ms / 1e3, 1)
        entries.append(entry)
        trained[arch] = (weights, meta)
        print(json.dumps(entry), flush=True)
        (out / "nif_reference_scale.json").write_text(json.dumps(doc, indent=2))

    # The decision rule, applied on-class.
    canon = "320"
    if args.no_ship or canon not in trained:
        decision = "not shipped" + ("" if args.no_ship else ": no canonical 320 in --archs")
    else:
        ship(out, *trained[canon], "urban_alley_synth_nif", canon, args.epochs,
             args.batch_size, args.env)
        passing = [a for a in trained if a != canon and psnr[a] >= psnr[canon]
                   and rate.get(a, 0) > rate.get(canon, float("inf"))]
        if passing:
            winner = max(passing, key=lambda a: rate[a])
            ship(out, *trained[winner], "urban_alley_synth_tuned", winner, args.epochs,
                 args.batch_size, args.env)
            decision = (f"rule winner on-class: {winner} ({psnr[winner]} dB >= "
                        f"canonical {psnr[canon]} dB at {rate[winner]} vs "
                        f"{rate[canon]} Mpaths/s)")
        elif not rate:
            decision = "no render rates measured: the canonical 6x320 shipped, no rule applied"
        else:
            decision = (f"no faster arch matches canonical PSNR {psnr[canon]} dB "
                        "on-class; the canonical 6x320 is the tuned config here")
    doc[section]["decision"] = decision
    print(decision, flush=True)
    (out / "nif_reference_scale.json").write_text(json.dumps(doc, indent=2))
    print(f"wrote {out / 'nif_reference_scale.json'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
