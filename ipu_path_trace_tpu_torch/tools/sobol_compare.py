"""The equal-budget prng-against-Sobol figure.

Counterpart of ``scripts/sobol_compare.py``: two renders of the frame
(1104x1000, ``assets/nif_w192e16``, the coherent worklist) at the same
low total (``--spp`` 32, where the sampler's discrepancy shows), one with
the Philox stream and one with ``--sampler sobol``'s Owen-scrambled
points, side by side with a row of 2x crops over the sky gradient (the
smooth integrand where the stratification shows).  The visual companion
of ``probes/sobol_bench.py``.

    python3 -m ipu_path_trace_tpu_torch.tools.sobol_compare --out DIR [assets] \\
        [--spp 32] [--width 1104 --height 1000] [--seed 0] [--device cuda|cpu]

writes ``DIR/sobol_compare.png`` (never ``docs/``).
"""

from __future__ import annotations

import argparse
import sys

from ..probes import _study
from .adaptive_compare import ldr_of, side_by_side

CROP = (0.18, 0.30)  # crop centre as fractions of (height, width): the sky


def main(argv=None) -> int:
    from ..core.scene import default_scene
    from ..film.imageio import write_png
    from ..render.params import StaticConfig

    ap = argparse.ArgumentParser(prog="sobol_compare", description=__doc__.split("\n")[0])
    _study.add_common(ap)
    ap.add_argument("--spp", type=int, default=32, help="samples a pixel of each image")
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    args = ap.parse_args(argv)
    dev = _study.device_of(args.device, "sobol_compare")
    out = _study.out_dir(args.out)
    env = _study.load_env(args.assets, dev)
    scene = default_scene(dev)
    w, h = args.width, args.height
    wl, _ = _study.coherent_worklist(scene, w, h)
    seed = _study.step_seed(_study.base(args.seed, _study.CURVE_TAG), 0)

    def render(sampler: str):
        cfg = StaticConfig(width=w, height=h, sampler=sampler)
        work = _study.uniform_steps(scene, env, cfg, _study.batch(wl, dev), args.spp, [seed])
        return ldr_of(work, w, h)

    path = out / "sobol_compare.png"
    write_png(str(path), side_by_side(render("prng"), render("sobol"), CROP))
    print(f"wrote {path}: prng (left) vs sobol (right), {args.spp} spp each; bottom row = 2x "
          f"crop over the sky gradient")
    return 0


if __name__ == "__main__":
    sys.exit(main())
