"""Replay the shipped NIF recipes with the port's trainer on the card.

1. The canonical asset's recorded ``train_command``
   (``assets/urban_alley_synth_nif/nif_metadata.txt``: 6x320, E=12, skip
   3, ``synth:urban-alley:2048x4096:seed7``, 6000 epochs of 2 steps at
   batch 65,536, cosine) parsed by the port's trainer CLI and run for
   seeds 0 and 1 (the seed-to-seed spread), each result scored with the
   quality gate (K4 over the 2048x4096 frame, bf16, log-radiance PSNR).
2. The int8 asset's QAT recipe: its recorded ``scripts/quant_qat.py``
   argv (3000 epochs, lr 2e-4, the 256x512 calibration grid) given to the
   port's ``tools/quant_qat.main``, which fine-tunes the shipped bf16
   asset, writes the int8 asset and scores it as the renderer loads it.
3. The shipped assets scored the same way in the same run: bf16, and the
   int8 asset with its ``quant_amax.json``.

Each training run's seconds, median ms per step (CUDA events) beside the
step's bound - the forward and backward products, 3 x 2 x MACs per
sample x batch, over the H100's 67 TFLOP/s f32 peak - and first and final
loss, and every PSNR, go into one JSON line.  The recipes run in full
(minutes on the card); ``--out`` keeps the trained assets (default: a
temporary directory, removed).

    python -m ipu_path_trace_tpu_torch.probes.train_replay [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..models import train_nif
from ..models.nif import load_nif_assets
from ..models.reconstruct import reconstruct_image
from ..models.synth_env import resolve_synth
from ..runtime.app import parse_env_assets
from ..tools import quant_qat
from .quant_psnr import psnr_log, reconstruct_quant

ASSETS = Path(__file__).resolve().parents[2] / "assets"
CANONICAL = ASSETS / "urban_alley_synth_nif"
INT8 = ASSETS / "urban_alley_synth_nif_int8"
F32_PEAK = 67e12  # H100 SXM f32 (non-tensor) FLOP/s, dense, NVIDIA's data sheet
MAX_BATCH = 1 << 19
SEEDS = (0, 1)


def recorded_command(asset: Path) -> list[str]:
    with open(asset / "nif_metadata.txt") as f:
        return json.load(f)["train_command"]


def step_bound_ms(weights, batch: int) -> float:
    """Forward and backward products of one step over the f32 peak."""
    macs = sum(l.kernel.shape[0] * l.kernel.shape[1] for l in weights.layers)
    return 3 * 2 * macs * batch / F32_PEAK * 1e3


def summary(record: dict, seconds: float, loss: float, bound: float) -> dict:
    return {"seconds": seconds, "steps": len(record["step_ms"]),
            "median_step_ms": statistics.median(record["step_ms"]), "step_bound_ms": bound,
            "first_loss": record["losses"][0], "final_loss": loss}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="train_replay")
    ap.add_argument("--out", default=None, help="keep the trained assets here")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    device = train_nif.check_device(args.device)
    out = Path(args.out or tempfile.mkdtemp(prefix="train_replay_"))
    cmd = recorded_command(CANONICAL)
    parser = train_nif.build_parser()
    base = parser.parse_args(cmd[3:])
    t0 = time.monotonic()
    img = resolve_synth(base.input)
    h, w = img.shape[:2]
    result = {"device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu"),
              "recipe": cmd[3:], "image_seconds": time.monotonic() - t0, "runs": {}}
    print(f"[train_replay] {base.input} in {result['image_seconds']:.1f}s", file=sys.stderr)

    def gate_bf16(asset: Path) -> float:
        model = load_nif_assets(str(asset), torch.bfloat16, device)[0]
        return psnr_log(reconstruct_image(model, h, w, max_batch_size=MAX_BATCH), img)

    try:
        for seed in SEEDS:
            run = parser.parse_args([*cmd[3:], "--seed", str(seed), "--device", str(device)])
            run.out_dir = str(out / f"seed{seed}")
            record: dict = {}
            t0 = time.monotonic()
            loss = train_nif.run(run, img, record)
            secs = time.monotonic() - t0
            weights = load_nif_assets(run.out_dir)[2]
            entry = summary(record, secs, loss, step_bound_ms(weights, run.batch_size))
            entry["epochs"] = run.epochs
            entry["bf16_psnr_db"] = gate_bf16(Path(run.out_dir))
            result["runs"][f"seed{seed}"] = entry
            print(f"[train_replay] seed {seed}: {json.dumps(entry)}", file=sys.stderr, flush=True)

        qcmd = recorded_command(INT8)
        # the script writes its asset only when the gate passes unless given
        # --save-always; the port's tool always writes it (into --out)
        qargv = [a for a in qcmd[qcmd.index("scripts/quant_qat.py") + 1:] if a != "--save-always"]
        q = quant_qat.main([*qargv, "--env", base.input, "--out", str(out / "qat"),
                            "--device", str(device)])
        entry = {"seconds": q["train_seconds"], "steps": q["steps"],
                 "median_step_ms": q["median_step_ms"],
                 "step_bound_ms": step_bound_ms(load_nif_assets(str(out / "qat"))[2],
                                                q["batch_size"]),
                 "first_loss": q["first_loss"], "final_loss": q["final_loss"],
                 "epochs": q["epochs"], "int8_psnr_db": q["int8_psnr_db"],
                 "int8_psnr_recalibrated_db": q["int8_psnr_recalibrated_db"], "amax": q["amax"]}
        result["runs"]["qat"] = entry
        print(f"[train_replay] qat: {json.dumps(entry)}", file=sys.stderr, flush=True)

        shipped_int8 = parse_env_assets(str(INT8), device, "int8")[0].model
        result["shipped"] = {
            "bf16_psnr_db": gate_bf16(CANONICAL),
            "int8_psnr_db": psnr_log(reconstruct_quant(shipped_int8, h, w, MAX_BATCH), img),
        }
    finally:
        if args.out is None:
            shutil.rmtree(out, ignore_errors=True)
    bf16 = [r["bf16_psnr_db"] for k, r in result["runs"].items() if k.startswith("seed")]
    result["seed_spread_db"] = max(bf16) - min(bf16)
    result["gap_to_shipped_bf16_db"] = result["shipped"]["bf16_psnr_db"] - max(bf16)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
