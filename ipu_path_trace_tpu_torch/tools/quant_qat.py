"""QAT fine-tune of the reference-scale NIF for the int8 chain.

Port of ``scripts/quant_qat.py``: re-fits the canonical 6x320
(``assets/urban_alley_synth_nif``) THROUGH the inference quantiser
(models/quant.qat_finetune: STE fake-quant of the features, the
per-channel weights and the fixed calibrated activation grids) on the
synthetic frame it was trained on, writes the asset and scores it as
the renderer loads it (``runtime/app.parse_env_assets(..., "int8")``:
the weights as the asset stores them, in f16, quantised with the
fine-tune's grids) with the port's quality gate
(probes/quant_psnr.reconstruct_quant, K4 on the card) against the ground
truth; and once more with grids re-calibrated from the stored weights.

    python -m ipu_path_trace_tpu_torch.tools.quant_qat [--assets DIR] [--epochs 3000]
        [--batch-size 65536] [--train-samples 131072] [--lr 2e-4] [--seed 0]
        [--grid 256x512] [--max-batch N] [--env synth:...] [--out DIR] [--device cuda|cpu]

prints its entry as one JSON line (the script also wrote it into
docs/QUANT.json, a TPU record; nothing is written there).  The asset -
converted.hdf5, nif_metadata.txt and quant_amax.json with the grids the
fine-tune trained against - is kept in ``--out`` when given; there is no
default (the shipped assets belong to the tests), and without it the
asset is scored from a temporary directory and removed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import torch

from ..models.nif import load_nif_assets
from ..models.quant import qat_finetune, quantize_nif
from ..models.synth_env import resolve_synth
from ..models.train_nif import check_device, save_assets
from ..probes.quant_psnr import ASSET, SYNTH, psnr_log, reconstruct_quant
from ..runtime.app import parse_env_assets

BF16_GATE_DB = 36.2971  # the shipped asset's bf16 gate on the H100 (PERF.md)


def save_qat_asset(out: str, weights, meta, amax, grid: str, train_command) -> None:
    """converted.hdf5 + nif_metadata.txt + quant_amax.json (the grids)."""
    save_assets(out, weights, meta, train_command)
    with open(os.path.join(out, "quant_amax.json"), "w") as f:
        json.dump({"amax": [float(a) for a in amax], "calibration_grid": grid}, f, indent=2)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="quant_qat")
    ap.add_argument("--assets", default=str(ASSET))
    ap.add_argument("--out", default=None,
                    help="keep the fine-tuned asset in this directory (no default)")
    ap.add_argument("--epochs", type=int, default=3000)
    ap.add_argument("--batch-size", type=int, default=65536)
    ap.add_argument("--train-samples", type=int, default=131072)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grid", default="256x512")
    ap.add_argument("--max-batch", type=int, default=1 << 19)
    ap.add_argument("--env", default=SYNTH,
                    help="the training image and ground truth, a synth: pseudo-path")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    src = resolve_synth(args.env)
    if src is None:
        raise SystemExit(f"quant_qat: --env must be a synth: pseudo-path, got {args.env!r}")
    h, w = src.shape[:2]
    _, meta, weights = load_nif_assets(args.assets)
    gh, gw = (int(x) for x in args.grid.split("x"))

    t0 = time.monotonic()
    record: dict = {}
    new_weights, amax, loss = qat_finetune(
        weights, meta, src, epochs=args.epochs, batch_size=args.batch_size,
        train_samples=args.train_samples, learning_rate=args.lr, calib_grid=(gh, gw),
        seed=args.seed, device=device, record=record)
    t_train = time.monotonic() - t0
    print(f"QAT {args.epochs} epochs in {t_train:.1f}s, loss {loss:.6f}", file=sys.stderr)

    cmd = ["python", "-m", "ipu_path_trace_tpu_torch.tools.quant_qat",
           "--epochs", str(args.epochs), "--batch-size", str(args.batch_size),
           "--train-samples", str(args.train_samples), "--lr", str(args.lr),
           "--seed", str(args.seed), "--grid", args.grid, "--env", args.env]
    out = args.out or tempfile.mkdtemp(prefix="quant_qat_")
    try:
        save_qat_asset(out, new_weights, meta, amax, args.grid, cmd)
        qmodel = parse_env_assets(out, device, "int8")[0].model
        p_qat = psnr_log(reconstruct_quant(qmodel, h, w, args.max_batch), src)
        print(f"QAT int8 PSNR {p_qat:.2f} dB", file=sys.stderr)
        # grids re-calibrated from the stored weights: are the sidecar's load-bearing?
        qrecal = quantize_nif(load_nif_assets(out)[2], meta, grid=(gh, gw), device=device)
        p_recal = psnr_log(reconstruct_quant(qrecal, h, w, args.max_batch), src)
        print(f"QAT int8 PSNR (recalibrated amax) {p_recal:.2f} dB", file=sys.stderr)
    finally:
        if args.out is None:
            shutil.rmtree(out, ignore_errors=True)

    entry = {
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "train_samples": args.train_samples,
        "learning_rate": args.lr,
        "train_seconds": t_train,
        "steps": len(record["step_ms"]),
        "median_step_ms": statistics.median(record["step_ms"]),
        "first_loss": record["losses"][0],
        "final_loss": loss,
        "int8_psnr_db": p_qat,
        "int8_psnr_recalibrated_db": p_recal,
        "gate_bf16_psnr_db": BF16_GATE_DB,
        "passes_gate": bool(p_qat >= BF16_GATE_DB),
        "amax": [float(a) for a in amax],
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    if args.out:
        entry["out"] = args.out
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps(entry), flush=True)
    return entry


if __name__ == "__main__":
    main()
