"""On-class quality gate of the narrow NIF chain: bf16 against int8 PTQ,
with the f32 chain beside them.

Replaces ``scripts/quant_psnr.py``: loads the shipped reference-scale
asset (``assets/urban_alley_synth_nif``, the canonical 6x320 trained on
``synth:urban-alley:2048x4096:seed7``), quantises it after training
(models/quant.quantize_nif on a 256x512 calibration lattice),
reconstructs the full 2048x4096 frame with the bf16 and with the int8
chain, and with the asset's weights in f32 (the f32 chain, TF32 wgmma
on the card: ``--partials-type float``), all through K4 on CUDA
(ops/nif.py::nif_apply_t; the plain versions on the CPU), and scores
each against the generator's ground truth with the log-radiance PSNR of
``scripts/nif_width_sweep.py``.

    python -m ipu_path_trace_tpu_torch.probes.quant_psnr [--assets DIR] [--grid 256x512] \\
        [--max-batch N] [--env synth:urban-alley:<H>x<W>:seed<N>] [--device cuda|cpu]

prints the script's "quality" section as one JSON line (the script
wrote it into docs/QUANT.json, a TPU record; nothing is written here).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..models.nif import load_nif_assets
from ..models.quant import QuantNifModel, quantize_nif
from ..models.reconstruct import reconstruct_image, uv_grid
from ..models.synth_env import resolve_synth
from ..ops.nif import nif_apply_t

SYNTH = "synth:urban-alley:2048x4096:seed7"
ASSET = Path(__file__).resolve().parents[2] / "assets" / "urban_alley_synth_nif"


def psnr_log(img: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> float:
    """PSNR in the log-radiance domain, the NIF's training target
    (scripts/nif_width_sweep.py::psnr_log)."""
    a = np.log(np.maximum(img, 0.0) + eps)
    b = np.log(np.maximum(ref, 0.0) + eps)
    mse = float(np.mean((a - b) ** 2))
    peak = float(b.max() - b.min())
    return 10.0 * np.log10(peak * peak / mse)


def reconstruct_quant(qmodel: QuantNifModel, h: int, w: int, max_batch: int) -> np.ndarray:
    """The full frame through the int8 chain in fixed chunks of max_batch
    points (the last one shorter), on reconstruct's lattice u = k / H,
    with its bgr -> rgb flip -> (H, W, 3) f32."""
    u, v = uv_grid(h, w)
    out = np.empty((h * w, 3), np.float32)
    dev = qmodel.device
    for lo in range(0, h * w, max_batch):
        sl = slice(lo, min(lo + max_batch, h * w))
        rgb = nif_apply_t(qmodel, torch.from_numpy(u[sl]).to(dev), torch.from_numpy(v[sl]).to(dev))
        out[sl] = rgb.t().cpu().numpy()
    return out.reshape(h, w, 3)[..., ::-1].copy()


def main(argv=None) -> dict:
    """Reconstruct and score the three chains; print and return the quality section."""
    ap = argparse.ArgumentParser(prog="quant_psnr")
    ap.add_argument("--assets", default=str(ASSET))
    ap.add_argument("--grid", default="256x512", help="calibration lattice HxW")
    ap.add_argument("--max-batch", type=int, default=1 << 19)
    ap.add_argument("--env", default=SYNTH,
                    help="the ground truth, a synth:urban-alley:<H>x<W>:seed<N> pseudo-path")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the NIF kernel (K4); 'cpu' its plain version.")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quant_psnr: CUDA is not available; --device cpu runs the plain "
                         "versions")
    src = resolve_synth(args.env)  # (H, W, 3) ground truth
    if src is None:
        raise SystemExit(f"quant_psnr: --env must be a synth: pseudo-path, got {args.env!r}")
    h, w = src.shape[:2]
    model, meta, weights = load_nif_assets(args.assets, torch.bfloat16, args.device)

    gh, gw = (int(x) for x in args.grid.split("x"))
    t0 = time.monotonic()
    qmodel = quantize_nif(weights, meta, grid=(gh, gw), device=args.device)
    print(f"quantised in {time.monotonic() - t0:.1f}s (calibration {gh}x{gw})", file=sys.stderr)

    t0 = time.monotonic()
    p_bf16 = psnr_log(reconstruct_image(model, h, w, max_batch_size=args.max_batch), src)
    print(f"bf16 PSNR {p_bf16:.2f} dB ({time.monotonic() - t0:.1f}s)", file=sys.stderr)

    t0 = time.monotonic()
    p_q = psnr_log(reconstruct_quant(qmodel, h, w, args.max_batch), src)
    print(f"int8 PSNR {p_q:.2f} dB ({time.monotonic() - t0:.1f}s)", file=sys.stderr)

    t0 = time.monotonic()
    model32 = load_nif_assets(args.assets, torch.float32, args.device)[0]
    p_f32 = psnr_log(reconstruct_image(model32, h, w, max_batch_size=args.max_batch), src)
    print(f"f32 PSNR {p_f32:.2f} dB ({time.monotonic() - t0:.1f}s)", file=sys.stderr)

    quality = {
        "asset": Path(args.assets).name,
        "env": args.env,
        "metric": "psnr_log_db (scripts/nif_width_sweep.psnr_log), full frame",
        "calibration_grid": f"{gh}x{gw}",
        "device": (torch.cuda.get_device_name(torch.device(args.device))
                   if torch.device(args.device).type == "cuda" else "cpu, plain versions"),
        "bf16_psnr_db": p_bf16,
        "int8_psnr_db": p_q,
        "f32_psnr_db": p_f32,
    }
    print(json.dumps(quality), flush=True)
    return quality


if __name__ == "__main__":
    main()
