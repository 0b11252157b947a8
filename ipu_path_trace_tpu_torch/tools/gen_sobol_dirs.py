"""Regenerate the Sobol direction table the port carries.

Counterpart of ``scripts/gen_sobol_dirs.py``: the Joe & Kuo (2008)
direction numbers as scipy ships them (``scipy.stats.qmc.Sobol``,
bits=32) for the first 44 dimensions (4 camera dims and 4 a bounce at the
default max path length 10), written as the module
``render/_sobol_dirs.py`` is, so that the renderer needs no scipy.
Direction numbers are published mathematical data.  The table it writes
equals ``render/_sobol_dirs.DIRS`` word for word.

    python3 -m ipu_path_trace_tpu_torch.tools.gen_sobol_dirs --out DIR

writes ``DIR/_sobol_dirs.py`` (never the package's own file; copy it over
to change the table, with csrc/sobol_dirs.cuh).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

NUM_DIMS = 44
NUM_BITS = 32


def directions(num_dims: int = NUM_DIMS, num_bits: int = NUM_BITS) -> tuple:
    """DIRS[d][k]: the 32-bit direction number v_k of dimension d."""
    from scipy.stats import qmc

    sv = np.asarray(qmc.Sobol(d=num_dims, scramble=False, bits=num_bits)._sv, dtype=np.uint64)
    if sv.shape != (num_dims, num_bits):
        raise ValueError(f"scipy's Sobol table has shape {sv.shape}, not {(num_dims, num_bits)}")
    return tuple(tuple(int(v) for v in row) for row in sv)


def module_text(dirs: tuple) -> str:
    """The module's source: its docstring, then DIRS one dimension a line."""
    from ..render import _sobol_dirs

    lines = ['"""' + _sobol_dirs.__doc__ + '"""', "", "DIRS = ("]
    lines += ["    (" + ", ".join(f"0x{v:08x}" for v in row) + ")," for row in dirs]
    lines += [")", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gen_sobol_dirs", description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for _sobol_dirs.py")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "_sobol_dirs.py"
    path.write_text(module_text(directions()))
    print(f"wrote {path}: {NUM_DIMS} dims x {NUM_BITS} bits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
