"""Standalone NIF evaluation: reconstruct the environment map.

Counterpart of ``ipu_path_trace_tpu/models/reconstruct.py``: generate the
full UV grid (u = row / height, v = col / width, the reference's
makeGridCoordsUV), evaluate the NIF in batches serialised under a cap,
decode, and reassemble the image with the renderer's bgr -> rgb flip.
On CUDA every batch goes through K4 (ops/nif.py::nif_apply_t): the bf16
or the f32 chain (tf32 wgmma) for a bf16 or f32 ``NifModel``, the int8
chain for a ``QuantNifModel``; on the CPU through its plain version.

    python -m ipu_path_trace_tpu_torch.models.reconstruct <assets_dir> <out.exr|png> \\
        [height width] [--max-batch-size N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

from ..film.imageio import write_exr, write_png
from ..ops.nif import nif_apply_t
from ..utils.logging import handler, set_log_level
from .nif import NifModel, load_nif_assets

log = logging.getLogger(__name__)


def uv_grid(height: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-major UV grid exactly as makeGridCoordsUV: (u, v) f32 of H * W."""
    rows, cols = np.meshgrid(
        np.arange(height, dtype=np.float32), np.arange(width, dtype=np.float32), indexing="ij"
    )
    return (rows / height).ravel(), (cols / width).ravel()


def batch_split(n: int, max_batch_size: int) -> tuple[int, int]:
    """(factor, batch): the smallest divisor count of n keeping batches
    within max_batch_size, the app's serialisation."""
    factor = max(1, -(-n // max_batch_size))
    while n % factor:
        factor += 1
    return factor, n // factor


def reconstruct_image(model: NifModel, height: int, width: int,
                      max_batch_size: int = 30 * 1472,
                      reverse_channels: bool = True) -> np.ndarray:
    """The NIF over the full image grid -> (H, W, 3) f32, serialised into
    ``batch_split`` batches; reverse_channels applies the bgr -> rgb flip."""
    u, v = uv_grid(height, width)
    n = u.size
    factor, batch = batch_split(n, max_batch_size)
    log.info(
        "Batch-size serialisation full-size: %d serial-size: %d factor: %d", n, batch, factor
    )
    out = np.empty((n, 3), np.float32)
    dev = model.device
    t0 = time.monotonic()
    for s in range(factor):
        sl = slice(s * batch, (s + 1) * batch)
        rgb = nif_apply_t(model, torch.from_numpy(u[sl]).to(dev), torch.from_numpy(v[sl]).to(dev))
        out[sl] = rgb.t().cpu().numpy()
    dt = time.monotonic() - t0
    log.info("Reconstructed %d samples in %.2fs (%.1f Msamples/s)", n, dt, n / dt / 1e6)
    img = out.reshape(height, width, 3)
    return img[..., ::-1].copy() if reverse_channels else img


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="reconstruct")
    p.add_argument("assets_dir")
    p.add_argument("outfile", help="output image (.exr or .png)")
    p.add_argument("size", nargs="*", type=int, metavar="height width",
                   help="override the metadata image shape")
    p.add_argument("--max-batch-size", type=int, default=30 * 1472,
                   help="NIF batch-serialisation cap (the app's --max-nif-batch-size)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' runs the NIF kernel (K4); 'cpu' its plain version.")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("reconstruct: CUDA is not available; --device cpu runs the plain "
                         "version")
    logging.basicConfig(level=logging.INFO, handlers=[handler()])
    set_log_level("info")
    model, meta, _ = load_nif_assets(args.assets_dir, torch.bfloat16, args.device)
    h, w = meta.image_shape[:2]
    if len(args.size) >= 2:
        h, w = args.size[0], args.size[1]
    img = reconstruct_image(model, h, w, max_batch_size=args.max_batch_size)
    if args.outfile.endswith(".png"):
        ldr = np.clip(np.power(np.maximum(img, 0.0), 1 / 2.2) * 255.0, 0, 255).astype(np.uint8)
        write_png(args.outfile, ldr)
    else:
        write_exr(args.outfile, img)
    log.info("Wrote %s (%dx%d)", args.outfile, w, h)
    return 0


if __name__ == "__main__":
    sys.exit(main())
