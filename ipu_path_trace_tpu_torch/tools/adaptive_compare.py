"""The equal-budget uniform-against-adaptive figure.

Counterpart of ``scripts/adaptive_compare.py``: two renders of the
frame (1104x1000, ``assets/nif_w192e16``, the coherent worklist) at the
same nominal total (``--steps`` 4 of ``--spp-step`` 128 spp, 512
spp-equivalent), one uniform and one adaptive on the same step seeds,
saved side by side with a row of 2x crops over the noisiest region (the
floor disc and the glass).  The visual companion of
``probes/adaptive_bench.py``.

    python3 -m ipu_path_trace_tpu_torch.tools.adaptive_compare --out DIR [assets] \\
        [--steps 4 --spp-step 128] [--width 1104 --height 1000] [--seed 0] \\
        [--device cuda|cpu]

writes ``DIR/adaptive_compare.png`` (never ``docs/``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..probes import _study

CROP = (0.62, 0.55)  # crop centre as fractions of (height, width): floor and glass


def ldr_of(work, width: int, height: int) -> np.ndarray:
    """The tone-mapped frame (exposure 0, gamma 2.2) of a running worklist."""
    from ..film.film import Film

    film = Film(width, height)
    film.accumulate_soa(*(t.cpu().numpy() for t in (work.u, work.v, work.r, work.g, work.b,
                                                    work.sample_count)))
    return film.ldr(1, exposure=0.0, gamma=2.2)


def side_by_side(left: np.ndarray, right: np.ndarray, crop_at: tuple[float, float],
                 crop: int = 220) -> np.ndarray:
    """Both frames side by side over a row of their 2x crops at ``crop_at``
    (the scripts' figure layout: white gaps of 8, dark padding)."""
    h, w = left.shape[:2]
    crop = min(crop, h, w)
    gap = np.full((h, 8, 3), 255, np.uint8)
    top = np.concatenate([left, gap, right], axis=1)
    cy = min(int(h * crop_at[0]), h - crop)
    cx = min(int(w * crop_at[1]), w - crop)
    crops = [np.repeat(np.repeat(img[cy:cy + crop, cx:cx + crop], 2, axis=0), 2, axis=1)
             for img in (left, right)]
    bottom = np.concatenate([crops[0], np.full((crops[0].shape[0], 8, 3), 255, np.uint8),
                             crops[1]], axis=1)
    if bottom.shape[1] > top.shape[1]:
        bottom = bottom[:, :top.shape[1]]
    pad = np.full((bottom.shape[0], top.shape[1] - bottom.shape[1], 3), 20, np.uint8)
    bottom = np.concatenate([bottom, pad], axis=1)
    return np.concatenate([top, np.full((8, top.shape[1], 3), 255, np.uint8), bottom], axis=0)


def main(argv=None) -> int:
    from ..core.scene import default_scene
    from ..film.imageio import write_png
    from ..render.adaptive import adaptive_render_step
    from ..render.params import RenderSettings, StaticConfig
    from ..render.wavefront import render_step

    ap = argparse.ArgumentParser(prog="adaptive_compare", description=__doc__.split("\n")[0])
    _study.add_common(ap)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--spp-step", type=int, default=128)
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    args = ap.parse_args(argv)
    dev = _study.device_of(args.device, "adaptive_compare")
    out = _study.out_dir(args.out)
    env = _study.load_env(args.assets, dev)
    scene = default_scene(dev)
    w, h = args.width, args.height
    cfg = StaticConfig(width=w, height=h)
    settings = RenderSettings.make(samples_per_step=args.spp_step)
    wl, _ = _study.coherent_worklist(scene, w, h)
    b = _study.base(args.seed, _study.CURVE_TAG)

    def render(adaptive: bool) -> np.ndarray:
        work = _study.batch(wl, dev)
        lum2 = torch.zeros_like(work.r)
        for step in range(1, args.steps + 1):
            k = _study.step_seed(b, step)
            if adaptive:
                work, lum2 = adaptive_render_step(scene, settings, cfg, work, lum2, k, env)
            else:
                work = render_step(scene, settings, cfg, work, k, env)
        return ldr_of(work, w, h)

    path = out / "adaptive_compare.png"
    write_png(str(path), side_by_side(render(False), render(True), CROP))
    print(f"wrote {path}: uniform (left) vs adaptive (right), {args.steps * args.spp_step} "
          f"spp-equivalent each; bottom row = 2x crop")
    return 0


if __name__ == "__main__":
    sys.exit(main())
