"""Where does the int8 PTQ quality loss come from?

Port of ``scripts/quant_ablation.py``: the NIF forward in f32 with each of
the three quantisation points switched on alone (the rest f32), then all
three, scored against the generator's ground truth with the gate's
log-radiance PSNR:

* ``feats``   - the Fourier features snapped to the constant 1/127 grid
                (the floor no weight adaptation can cross);
* ``weights`` - per-output-channel int8 weights, f32 activations;
* ``acts``    - post-ReLU activations on the calibrated per-layer grids,
                f32 weights and features.

The features are the port's kernel encode (models/nif.fourier_features,
the direct sin/cos that K2, K3 and K4 quantise; the script's counterpart
is the TPU kernel's ``nif_encode``).  ``selective_apply`` is plain PyTorch
on the given device (TF32 off on the card).  The reconstruction flips
bgr -> rgb before the PSNR, as the port's gate (probes/quant_psnr.py)
does; the script does not, so its PSNRs sit on a channel-permutation
floor and are not comparable with these.

    python -m ipu_path_trace_tpu_torch.probes.quant_ablation [--assets DIR] [--grid 256x512]
        [--eval-grid 1024x2048] [--max-batch N] [--env synth:...] [--device cuda|cpu]

prints one JSON line (the script wrote its section into docs/QUANT.json,
a TPU record; nothing is written here).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models.nif import NifMetaData, NifWeights, fourier_features, load_nif_assets
from ..models.quant import AQMAX, QMAX, _f32_chain_activations, calibration_features
from ..models.synth_env import resolve_synth
from ..models.train_nif import check_device, exact_f32
from .quant_psnr import ASSET, SYNTH, psnr_log

CASES = {
    "f32": dict(q_feats=False, q_weights=False, q_acts=False),
    "feats": dict(q_feats=True, q_weights=False, q_acts=False),
    "weights": dict(q_feats=False, q_weights=True, q_acts=False),
    "acts": dict(q_feats=False, q_weights=False, q_acts=True),
    "full": dict(q_feats=True, q_weights=True, q_acts=True),
}


def selective_apply(weights: NifWeights, meta: NifMetaData, u: torch.Tensor, v: torch.Tensor,
                    *, q_feats: bool, q_weights: bool, q_acts: bool, amax) -> torch.Tensor:
    """f32 NIF forward with each quantisation point switched on or off ->
    (P, 3) decoded radiance in network (bgr) order, on u's device."""
    dev = u.device
    feats = fourier_features(u, v, meta.embedding_dimension)  # (P, 4E)
    if q_feats:
        feats = torch.round(torch.clamp(feats, -1, 1) * QMAX) / QMAX
    x = feats
    nl = len(weights.layers)
    for i, l in enumerate(weights.layers):
        w = torch.from_numpy(l.kernel.astype(np.float32)).to(dev)
        if q_weights:
            sw = torch.clamp(w.abs().amax(dim=0), min=1e-12) / QMAX
            w = torch.clamp(torch.round(w / sw), -QMAX, QMAX) * sw
        if x.shape[-1] != w.shape[0]:
            x = torch.cat([x, feats], dim=-1)
        y = x @ w
        if l.bias is not None:
            y = y + torch.from_numpy(l.bias.astype(np.float32)).to(dev)
        if i < nl - 1:
            y = torch.relu(y)
            if q_acts:
                # the asymmetric inference grid: 256 levels over [0, a_i]
                step = amax[i] / AQMAX
                y = torch.clamp(torch.round(y / step), 0, AQMAX) * step
        x = y
    y = x * meta.max + torch.from_numpy(np.asarray(meta.mean, np.float32)).to(dev)
    return torch.exp(y) if meta.log_tone_map else y


def reconstruct(weights: NifWeights, meta: NifMetaData, h: int, w: int, max_batch: int,
                stride: int = 1, device="cpu", **flags) -> np.ndarray:
    """The frame at the training lattice u = (k * stride) / (h * stride),
    strided, in chunks of max_batch points -> (h, w, 3) rgb (flipped from
    the network's bgr)."""
    uu = (np.arange(h, dtype=np.float32) * stride) / (h * stride)
    vv = (np.arange(w, dtype=np.float32) * stride) / (w * stride)
    u, v = [g.reshape(-1) for g in np.meshgrid(uu, vv, indexing="ij")]
    out = np.empty((h * w, 3), np.float32)
    with exact_f32():
        for lo in range(0, h * w, max_batch):
            sl = slice(lo, min(lo + max_batch, h * w))
            out[sl] = selective_apply(weights, meta, torch.from_numpy(u[sl]).to(device),
                                      torch.from_numpy(v[sl]).to(device), **flags).cpu().numpy()
    return out.reshape(h, w, 3)[..., ::-1].copy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="quant_ablation")
    ap.add_argument("--assets", default=str(ASSET))
    ap.add_argument("--grid", default="256x512", help="calibration lattice HxW")
    ap.add_argument("--eval-grid", default="1024x2048",
                    help="PSNR evaluation resolution (the ground truth subsampled)")
    ap.add_argument("--max-batch", type=int, default=1 << 19)
    ap.add_argument("--env", default=SYNTH,
                    help="the ground truth, a synth:urban-alley:<H>x<W>:seed<N> pseudo-path")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    src = resolve_synth(args.env)
    if src is None:
        raise SystemExit(f"quant_ablation: --env must be a synth: pseudo-path, got {args.env!r}")
    eh, ew = (int(x) for x in args.eval_grid.split("x"))
    stride = src.shape[0] // eh
    if stride < 1 or src.shape[1] // ew != stride:
        raise SystemExit("quant_ablation: the eval grid must subsample H and W equally")
    src_eval = src[::stride, ::stride][:eh, :ew]
    _, meta, weights = load_nif_assets(args.assets)
    gh, gw = (int(x) for x in args.grid.split("x"))
    amax = _f32_chain_activations(weights, calibration_features(meta.embedding_dimension,
                                                                (gh, gw)))
    out = {"eval_grid": f"{eh}x{ew}", "calibration_grid": f"{gh}x{gw}",
           "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                      else "cpu")}
    for name, flags in CASES.items():
        t0 = time.monotonic()
        rec = reconstruct(weights, meta, eh, ew, args.max_batch, stride=stride, device=device,
                          amax=amax, **flags)
        out[name + "_psnr_db"] = psnr_log(rec, src_eval)
        print(f"{name:8s} {out[name + '_psnr_db']:6.2f} dB ({time.monotonic() - t0:.1f}s)",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
