"""Does the width rule survive a hard environment?  On the card.

Port of ``scripts/nif_hard_env_check.py``: generates the script's hard
equirect environment (``make_hard_env``, a numpy copy, bit for bit the
script's: multi-octave value noise with 24 sharp HDR emitters, 1024x2048
by default), trains each width (default 192, 256, 320) with the matched
recipe (models/train_nif.py, 2 optimizer steps an epoch, cosine decay,
seed 0) and scores the reconstruction (K4) with the log-radiance PSNR.

    python -m ipu_path_trace_tpu_torch.tools.nif_hard_env_check --out DIR [--epochs 6000] \\
        [--widths 192 256 320] [--embedding-dim 12] [--batch-size 65536] \\
        [--size 1024x2048] [--device cuda|cpu]

writes ``DIR/nif_hard_env.json`` (after every width); never
``docs/NIF_WIDTHS.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def make_hard_env(height: int = 1024, width: int = 2048, seed: int = 3) -> np.ndarray:
    """Multi-octave value noise + sharp HDR emitters, tonally like a
    city HDRI: broad dim structure plus small very bright sources."""
    rng = np.random.default_rng(seed)
    img = np.zeros((height, width, 3), np.float64)
    # Octaves of upsampled noise (bilinear) - sharp local contrast:
    for octave, amp in ((8, 0.6), (32, 0.5), (128, 0.4), (512, 0.3)):
        for c in range(3):
            coarse = rng.random((octave, octave * 2))
            ys = np.linspace(0, octave - 1, height)
            xs = np.linspace(0, octave * 2 - 1, width)
            y0 = np.floor(ys).astype(int)
            x0 = np.floor(xs).astype(int)
            y1 = np.minimum(y0 + 1, octave - 1)
            x1 = np.minimum(x0 + 1, octave * 2 - 1)
            fy = (ys - y0)[:, None]
            fx = (xs - x0)[None, :]
            up = (coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
                  + coarse[np.ix_(y1, x0)] * fy * (1 - fx)
                  + coarse[np.ix_(y0, x1)] * (1 - fy) * fx
                  + coarse[np.ix_(y1, x1)] * fy * fx)
            img[..., c] += amp * up
    img = np.maximum(img, 1e-3) ** 2.2  # deepen contrast
    # Sharp HDR emitters (sun/street lights):
    yy, xx = np.mgrid[0:height, 0:width]
    for _ in range(24):
        cy, cx = rng.integers(0, height), rng.integers(0, width)
        sigma = rng.uniform(1.5, 6.0)
        power = rng.uniform(50.0, 800.0)
        colour = rng.uniform(0.4, 1.0, 3)
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        img += (power * np.exp(-d2 / (2 * sigma * sigma)))[..., None] * colour
    return img.astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nif_hard_env_check")
    p.add_argument("--out", required=True, help="directory for nif_hard_env.json")
    p.add_argument("--epochs", type=int, default=6000)
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--widths", type=int, nargs="*", default=[192, 256, 320])
    p.add_argument("--embedding-dim", type=int, default=12, help="Fourier embedding dim E")
    p.add_argument("--size", default="1024x2048", help="HxW of the hard env")
    p.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    import torch

    from ..models.train_nif import check_device
    from .nif_reference_scale import score, train_one

    dev = check_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    h, w = (int(x) for x in args.size.split("x"))
    src = make_hard_env(h, w)
    print(f"hard env {w}x{h}, dyn range {src.min():.3g}..{src.max():.3g}", file=sys.stderr)
    results = []
    doc = {"hard_env": {"description": "multi-octave noise + 24 sharp HDR emitters "
                                       "(urban-alley-class frequency content); matched recipe, "
                                       "PSNR only",
                        "size": args.size, "epochs": args.epochs,
                        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu", "results": results}}
    for width in args.widths:
        t0 = time.monotonic()
        weights, meta, loss = train_one(src, width, args.embedding_dim, 6, args.epochs,
                                        args.batch_size, f"hard_env_{h}x{w}", dev)
        entry = {"width": width, "psnr_log_db": round(score(weights, meta, src, dev), 2),
                 "final_loss": loss, "train_seconds": round(time.monotonic() - t0, 1)}
        if args.embedding_dim != 12:
            entry["embedding_dim"] = args.embedding_dim
        results.append(entry)
        print(json.dumps(entry), flush=True)
        (out / "nif_hard_env.json").write_text(json.dumps(doc, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
