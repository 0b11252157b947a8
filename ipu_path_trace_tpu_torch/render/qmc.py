"""Hash-based Owen-scrambled Sobol sampling (``--sampler sobol``).

Counterpart of ``ipu_path_trace_tpu/render/qmc.py`` with the same
construction (Burley, "Practical Hash-based Owen Scrambling", JCGT 2020):
sample i of pixel p draws Sobol point ``nested_uniform_scramble(i,
pixel_seed(p))``, and each dimension's value goes through a second Owen
scramble keyed by the dimension.

PyTorch has no usable uint32 arithmetic, so every function here works on
int64 tensors that hold uint32 words (and on plain Python ints): shifts
and masks keep the low 32 bits, and a 32x32-bit product keeps its low
word through the 16-bit split of ``ops/trace._mulhilo32``, since a plain
int64 product overflows.  The functions run on either device; they are
the plain version of the kernels' Sobol rows (csrc/common.cuh::
SobolNoise), which compute the same words in uint32 registers.

The per-lane sequence index is the lane's count of samples so far (the
worklist's ``sample_count`` with the device film, ``(step - 1) *
samples_per_step`` with the host film) plus the sample's index within
the step, so the sequence continues across steps and adaptive budgets.
"""

from __future__ import annotations

import torch

from ..ops.trace import _mulhilo32
from ._sobol_dirs import DIRS

CAMERA_DIMS = 4  # AA jitter x2, lens x2, ahead of the 4 dims per bounce
MAX_DIMS = len(DIRS)

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # per-dimension seed salt


def _rev32_int(v: int) -> int:
    return int(f"{v:032b}"[::-1], 2)


# Bit-reversed once, as the reference does: accumulating with reversed
# directions yields reverse_bits(sobol(x)), the form the output scramble
# wants.  csrc/sobol_dirs.cuh holds the same table for the kernels.
REV_DIRS: tuple[tuple[int, ...], ...] = tuple(tuple(_rev32_int(v) for v in row) for row in DIRS)

if not all(DIRS[0][k] == (0x80000000 >> k) for k in range(32)):
    raise AssertionError("Sobol dimension 0 must be the van der Corput identity matrix")


def _mul32(x, c: int):
    """Low 32 bits of x * c for uint32 words x (tensor or int)."""
    return _mulhilo32(c, x)[1]


def reverse_bits32(x):
    """Bit-reverse each uint32 word (5-stage butterfly)."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _MASK32) | (x >> 16)


def lowbias32(x):
    """Wellons' lowbias32 integer hash."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def laine_karras(x, seed):
    """Laine-Karras hash: a random base-2 Owen scramble of the reversed
    input (constants from Burley, JCGT 2020)."""
    x = (x + seed) & _MASK32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def pixel_seed(pixel_id: torch.Tensor, key: int) -> torch.Tensor:
    """Per-pixel index-shuffle seed from the pixel id (v * width + u) and
    the render-wide Sobol key."""
    return lowbias32((pixel_id.to(torch.int64) + (int(key) & _MASK32)) & _MASK32)


def dim_seed(key: int, dim: int) -> int:
    """Per-dimension output-scramble seed."""
    return lowbias32(((int(key) & _MASK32) + ((dim * _GOLDEN) & _MASK32)) & _MASK32)


def scrambled_index_word(idx: torch.Tensor, pix_seed: torch.Tensor) -> torch.Tensor:
    """laine_karras(reverse_bits(i), seed): the shuffled sample index in
    bit-reversed form, as sobol_bits_shared consumes it."""
    return laine_karras(reverse_bits32(idx.to(torch.int64) & _MASK32), pix_seed)


def sobol_masks(h: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """mask[k] is all ones where bit 31 - k of h is set."""
    return tuple(((h >> (31 - k)) & 1) * _MASK32 for k in range(32))


def sobol_bits_shared(h: torch.Tensor, masks: tuple, dim: int) -> torch.Tensor:
    """reverse_bits(sobol_dim(shuffled index)): the XOR of the reversed
    direction numbers of h's set bits (dimension 0 is a bit reversal)."""
    if dim == 0:
        return reverse_bits32(h)
    rd = REV_DIRS[dim]
    acc = masks[0] & rd[0]
    for k in range(1, 32):
        acc = acc ^ (masks[k] & rd[k])
    return acc


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in (0, 1] from the top 24 bits."""
    return ((bits >> 8) + 1).to(torch.float32) * (1.0 / (1 << 24))


def sobol_uniforms(idx: torch.Tensor, pixel_id: torch.Tensor, key: int, dims) -> list[torch.Tensor]:
    """One (n,) float32 vector in (0, 1] per dimension in ``dims``: lane i
    draws point ``idx[i]`` of pixel ``pixel_id[i]``'s scrambled sequence."""
    h = scrambled_index_word(idx, pixel_seed(pixel_id, key))
    masks = sobol_masks(h)
    return [bits_to_unit(reverse_bits32(laine_karras(sobol_bits_shared(h, masks, d),
                                                     dim_seed(key, d))))
            for d in dims]
