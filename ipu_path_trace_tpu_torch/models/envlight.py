"""Environment lights: constant colour, equirect HDR texture, or NIF MLP.

Counterpart of ``ipu_path_trace_tpu/models/envlight.py``.  Escaped rays
are shaded after the trace; every variant returns RGB, and the NIF
variant reverses the network's channel order (bgr -> rgb).  A NIF is a
``NifModel`` (bf16 chain) or a ``QuantNifModel`` (int8 chain,
``--nif-precision int8``); the NIF kernels dispatch on the type.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vecmath import Vec3
from .nif import NifModel


class ConstantEnv(NamedTuple):
    """Uniform environment radiance."""

    colour: tuple[float, float, float]  # RGB


class TextureEnv(NamedTuple):
    """Equirectangular HDR texture lookup: u indexes rows (theta), v
    columns (phi), the convention the NIF is trained with."""

    texture: torch.Tensor  # (H, W, 3) float32 RGB
    bilinear: bool = False  # False: nearest texel


class NifEnv(NamedTuple):
    """Neural Image Field environment light."""

    model: NifModel


def eval_env(env, u: torch.Tensor, v: torch.Tensor) -> Vec3:
    """Environment radiance at equirect (u, v) in [0, 1].

    A NIF goes through the standalone NIF kernel (K4, ``ops/nif.py::
    nif_apply_t``) for CUDA tensors and its plain version for CPU
    tensors; the texture lookup is plain PyTorch, as the reference leaves
    it to XLA outside any kernel.
    """
    if isinstance(env, ConstantEnv):
        c = torch.tensor(env.colour, dtype=torch.float32, device=u.device)
        ones = torch.ones_like(u)
        return Vec3(c[0] * ones, c[1] * ones, c[2] * ones)
    if isinstance(env, TextureEnv):
        return _eval_texture(env, u, v)
    if isinstance(env, NifEnv):
        from ..ops.nif import nif_apply_t

        out = nif_apply_t(env.model, u, v)  # (3, P) network (bgr) order
        return Vec3(out[2], out[1], out[0])
    raise TypeError(f"Unknown environment light type: {type(env)!r}")


def bake_nif_env(env: NifEnv, height: int = 2048, width: int = 4096,
                 max_batch_size: int = 30 * 1472) -> TextureEnv:
    """Decode the NIF once into an equirect texture on the model's device
    (``--nif-mode baked``); escaped rays then read it bilinearly.

    The grid lies on the lookup lattice (u_k = k / (h - 1), v =
    linspace(0, 1, w)), so the bilinear lookup reproduces the NIF at
    lattice points.  Rows are evaluated in chunks of
    ``max(1, max_batch_size // width)`` rows (``--max-nif-batch-size``),
    one NIF-apply launch per chunk.
    """
    from ..ops.nif import nif_apply_t

    dev = env.model.device
    rows_per_chunk = max(1, max_batch_size // width)
    cols_v = torch.linspace(0.0, 1.0, width, dtype=torch.float32, device=dev)
    texture = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    for r0 in range(0, height, rows_per_chunk):
        r1 = min(r0 + rows_per_chunk, height)
        u = (torch.arange(r0, r1, dtype=torch.float32, device=dev) / (height - 1)
             ).repeat_interleave(width)
        v = cols_v.repeat(r1 - r0)
        out_t = nif_apply_t(env.model, u, v)  # (3, P) network (bgr) order
        texture[r0:r1] = out_t.flip(0).t().reshape(r1 - r0, width, 3)
    return TextureEnv(texture=texture, bilinear=True)


def _eval_texture(env: TextureEnv, u: torch.Tensor, v: torch.Tensor) -> Vec3:
    """Nearest or bilinear lookup; bilinear clamps at the poles and wraps
    the phi seam."""
    tex = env.texture
    h, w = tex.shape[0], tex.shape[1]
    rf = torch.clamp(u, 0.0, 1.0) * (h - 1)
    cf = torch.clamp(v, 0.0, 1.0) * (w - 1)
    if env.bilinear:
        r0 = torch.floor(rf).to(torch.int64)
        c0 = torch.floor(cf).to(torch.int64)
        r1 = torch.clamp_max(r0 + 1, h - 1)
        c1 = torch.remainder(c0 + 1, w)
        ar = (rf - r0)[:, None]
        ac = (cf - c0)[:, None]
        rgb = (tex[r0, c0] * (1 - ar) * (1 - ac) + tex[r0, c1] * (1 - ar) * ac
               + tex[r1, c0] * ar * (1 - ac) + tex[r1, c1] * ar * ac)
    else:
        r0 = torch.clamp(torch.round(rf).to(torch.int64), 0, h - 1)
        c0 = torch.clamp(torch.round(cf).to(torch.int64), 0, w - 1)
        rgb = tex[r0, c0]
    return Vec3(rgb[:, 0], rgb[:, 1], rgb[:, 2])
