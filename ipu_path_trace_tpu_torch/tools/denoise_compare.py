"""The raw-against-``--denoise`` figure, through the port's CLI.

Counterpart of ``scripts/denoise_compare.py``: the caustic scene
(``assets/scenes/glass_caustic.json``) under the procedural-sky texture
env at 16 spp, rendered twice by ``runtime/cli.py`` in a subprocess, once
raw and once with ``--denoise``, and the two images composed side by
side.  Each image is read back from the CLI's EXR twin and tone-mapped
(exposure 0, gamma 2.2; the port reads no PNG).

    python3 -m ipu_path_trace_tpu_torch.tools.denoise_compare --out DIR \\
        [--size 256] [--spp 16] [--device cuda|cpu]

writes ``DIR/denoise_compare.png`` and the two renders under ``DIR``
(never ``docs/``).
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np

from ..probes import _study


def render(out_png: str, size: int, spp: int, device: str, extra: list[str]) -> None:
    """One CLI render of the caustic scene; raises if the CLI fails."""
    cmd = [sys.executable, "-m", "ipu_path_trace_tpu_torch.runtime.cli",
           "-o", out_png, "-w", str(size), "-H", str(size),
           "-s", str(spp), "--samples-per-step", str(spp),
           "--scene", str(_study.SCENES / "glass_caustic.json"),
           "--assets", "texture:" + str(_study.ROOT / "assets" / "procedural_sky.exr"),
           "--seed", "5", "--device", device] + extra
    res = subprocess.run(cmd, cwd=_study.ROOT, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"denoise_compare: the CLI exited {res.returncode}: "
                           f"{res.stderr[-2000:]}")


def read_ldr(png_path: str) -> np.ndarray:
    """The CLI's image as 8-bit RGB, from its EXR twin."""
    from ..film.film import tone_map
    from ..film.imageio import read_exr

    return tone_map(read_exr(png_path[:-4] + ".exr"), 1, 0.0, 2.2)


def main(argv=None) -> int:
    from ..film.imageio import write_png

    ap = argparse.ArgumentParser(prog="denoise_compare", description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _study.device_of(args.device, "denoise_compare")
    out = _study.out_dir(args.out)
    raw, dn = str(out / "raw.png"), str(out / "denoised.png")
    render(raw, args.size, args.spp, args.device, [])
    render(dn, args.size, args.spp, args.device, ["--denoise"])
    a, b = read_ldr(raw), read_ldr(dn)
    path = out / "denoise_compare.png"
    write_png(str(path), np.concatenate([a, np.full((a.shape[0], 4, 3), 255, np.uint8), b],
                                        axis=1))
    print(f"wrote {path} (left: raw {args.spp} spp, right: --denoise)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
