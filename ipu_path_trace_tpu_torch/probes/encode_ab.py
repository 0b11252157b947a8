"""A/B the NIF kernel's Fourier encode against the trainer's direct trig.

Port of ``scripts/encode_ab.py``: the same weights (the canonical asset in
f32), the same evaluation lattice (the reconstruct lattice u = row / H,
v = col / W at ``--grid``, against the synthetic ground truth sampled at
the same points), the all-f32 chain, only the encode differs:

  * direct: the trainer's encode (models/nif.fourier_features, torch
    sin / cos) through the plain f32 chain;
  * kernel: the encode K4 computes on the card (csrc/nif_dev.cuh
    ``fourier``: sincosf of each octave's angle, where the TPU kernel ran
    a double-angle recurrence) with K4's f32 chain (tf32 ``wgmma``,
    3xTF32); on the CPU K4's plain version, so there it equals direct;
  * old_recurrence: the pre-r5 TPU kernel encode (a pure double-angle
    recurrence seeded once at octave 0, ``_old_recurrence``) through the
    plain f32 chain, for the record.

Each reconstruction is flipped bgr -> rgb (the renderer's channel order)
before its log-radiance PSNR (probes/quant_psnr.psnr_log); the script
scores the network's bgr order against the rgb ground truth.

    python -m ipu_path_trace_tpu_torch.probes.encode_ab --out DIR [--assets DIR] \\
        [--grid 2048x4096] [--max-batch 131072] [--env synth:...] [--device cuda|cpu]

writes ``DIR/encode_ab.json`` and prints it as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .quant_psnr import ASSET, SYNTH


def _double_angle(s: torch.Tensor, c: torch.Tensor, n: int) -> tuple[list, list]:
    """sin and cos of 2^j x for j < n from those of x, by
    sin 2a = 2 sin a cos a, cos 2a = 1 - 2 sin^2 a."""
    ss, cs = [s], [c]
    for _ in range(n - 1):
        s, c = ss[-1], cs[-1]
        ss.append(2.0 * s * c)
        cs.append(1.0 - 2.0 * s * s)
    return ss, cs


def _old_recurrence(u: torch.Tensor, v: torch.Tensor, embedding_dim: int) -> torch.Tensor:
    """The pre-r5 kernel encode: pure double-angle recurrence seeded once
    at octave 0 (drifts ~2^j ulps; kept for the record) -> (4E, P)."""
    uu = 2.0 * (u - 1.0)
    vv = 2.0 * (v - 1.0)
    sus, cus = _double_angle(torch.sin(uu), torch.cos(uu), embedding_dim)
    svs, cvs = _double_angle(torch.sin(vv), torch.cos(vv), embedding_dim)
    return torch.stack(sus + svs + cus + cvs, dim=0)


def _decode(model, y: torch.Tensor) -> torch.Tensor:
    y = y * model.max + torch.tensor(model.mean, device=y.device)
    return torch.exp(y) if model.log_tone_map else y


def reconstruct(model, h: int, w: int, max_batch: int, encode: str) -> np.ndarray:
    """(H, W, 3) rgb over the reconstruct lattice with one encode."""
    from ..models.nif import fourier_features, mlp_chain
    from ..models.reconstruct import uv_grid
    from ..ops.nif import nif_apply_t

    u, v = uv_grid(h, w)
    out = np.empty((h * w, 3), np.float32)
    dev = model.device
    for lo in range(0, h * w, max_batch):
        sl = slice(lo, min(lo + max_batch, h * w))
        uu, vv = torch.from_numpy(u[sl]).to(dev), torch.from_numpy(v[sl]).to(dev)
        if encode == "kernel":
            y = nif_apply_t(model, uu, vv).t()
        else:
            feats = (fourier_features(uu, vv, model.embedding_dim) if encode == "direct"
                     else _old_recurrence(uu, vv, model.embedding_dim).t())
            y = _decode(model, mlp_chain(model, feats))
        out[sl] = y.cpu().numpy()
    return out.reshape(h, w, 3)[..., ::-1].copy()  # bgr -> rgb


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="encode_ab")
    ap.add_argument("--out", required=True, help="directory for encode_ab.json")
    ap.add_argument("--assets", default=str(ASSET))
    ap.add_argument("--grid", default="2048x4096")
    ap.add_argument("--max-batch", type=int, default=131072)
    ap.add_argument("--env", default=SYNTH,
                    help="the ground truth, a synth:urban-alley:<H>x<W>:seed<N> pseudo-path")
    ap.add_argument("--device", default="cuda", help="'cuda' (K4 for the kernel arm) or 'cpu'")
    args = ap.parse_args(argv)

    from ..models.nif import load_nif_assets
    from ..models.synth_env import resolve_synth
    from ..models.train_nif import check_device
    from .quant_psnr import psnr_log

    dev = check_device(args.device)
    src = resolve_synth(args.env)
    if src is None:
        raise SystemExit(f"encode_ab: --env must be a synth: pseudo-path, got {args.env!r}")
    h, w = (int(x) for x in args.grid.split("x"))
    src_eval = src[::src.shape[0] // h, ::src.shape[1] // w]
    model = load_nif_assets(args.assets, torch.float32, dev)[0]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 chain in f32
    try:
        res = {"eval_grid": args.grid, "env": args.env, "assets": Path(args.assets).name,
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
               else "cpu, plain versions"}
        for encode in ("direct", "kernel", "old_recurrence"):
            t0 = time.monotonic()
            p = psnr_log(reconstruct(model, h, w, args.max_batch, encode), src_eval)
            res[encode + "_psnr_db"] = round(p, 2)
            print(f"{encode:14s} {p:6.2f} dB ({time.monotonic() - t0:.1f}s)", file=sys.stderr)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    # Feature drift of the old recurrence at the top octave, for the record.
    from ..models.nif import fourier_features

    uu = torch.linspace(0.0, 1.0, 4096)
    vv = torch.zeros_like(uu)
    e = model.embedding_dim
    res["old_recurrence_feat_absdiff_max"] = float(
        (fourier_features(uu, vv, e) - _old_recurrence(uu, vv, e).t()).abs().max())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "encode_ab.json").write_text(json.dumps(res, indent=2))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
