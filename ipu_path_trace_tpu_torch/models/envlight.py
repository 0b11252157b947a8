"""Environment lights: constant colour or NIF MLP.

Counterpart of ``ipu_path_trace_tpu/models/envlight.py``.  Escaped rays
are shaded after the trace; every variant returns RGB, and the NIF
variant reverses the network's channel order (bgr -> rgb).  The texture
env and NIF baking are not ported yet (ROADMAP queue 1 item 20).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vecmath import Vec3
from .nif import NifModel, nif_apply


class ConstantEnv(NamedTuple):
    """Uniform environment radiance."""

    colour: tuple[float, float, float]  # RGB


class NifEnv(NamedTuple):
    """Neural Image Field environment light."""

    model: NifModel


def eval_env(env, u: torch.Tensor, v: torch.Tensor) -> Vec3:
    """Environment radiance at equirect (u, v) in [0, 1].

    The NIF variant is the plain version of the standalone NIF kernel,
    which is not ported yet (ROADMAP queue 2, K4): it serves CPU tensors
    only and raises for CUDA tensors.  The render path shades NIF
    escapes through the env-shade kernel instead (ops/nif.py).
    """
    if isinstance(env, ConstantEnv):
        c = torch.tensor(env.colour, dtype=torch.float32, device=u.device)
        ones = torch.ones_like(u)
        return Vec3(c[0] * ones, c[1] * ones, c[2] * ones)
    if isinstance(env, NifEnv):
        if u.is_cuda:
            raise NotImplementedError(
                "NIF evaluation at (u, v) on CUDA needs the standalone NIF "
                "kernel, not ported yet (ROADMAP.md queue 2, K4)")
        out = nif_apply(env.model, u, v)
        return Vec3(out[:, 2], out[:, 1], out[:, 0])
    raise TypeError(f"Unknown environment light type: {type(env)!r}")
