"""K3: the megastep kernel - a whole render step (sample loop, trace and
NIF env shade) in one launch.

Replaces ``ipu_path_trace_tpu/ops/megastep_pallas.py::render_megastep_pallas``
(``csrc/megastep.cu``).  ``render_megastep`` launches it for CUDA tensors
and runs ``render_megastep_plain`` - the per-sample composition of the
plain trace (ops/trace.py) and the plain env shade (ops/nif.py) - for CPU
tensors.  Returns the SUM over the step's samples of radiance (env light
applied) and of path length.

Ported modes: hardware (Philox, ``seed``) and host noise (``noise`` of
shape (S, 4 + 4L, P)), each with the bf16 chain (``NifModel``) or the
int8 chain (``QuantNifModel``).  Per-block budgets and ``with_stats``
(ROADMAP queue 1 item 9), ``env_skip`` (item 11), Sobol (item 10) and the
measurement stubs (item 16) raise NotImplementedError.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.scene import Scene
from ..core.vecmath import Vec3
from ..models.nif import NifModel
from . import _lib
from .nif import model_tensors, net_struct, nif_env_shade_plain
from .trace import pack_scene, trace_params, trace_sample_plain


class MegaStepOut(NamedTuple):
    radiance: Vec3  # per-pixel radiance sum over the step's samples
    path_len: torch.Tensor  # int32 path-length sum


def _samples(settings, noise) -> int:
    return settings.samples_per_step if noise is None else noise.shape[0]


def render_megastep_plain(scene: Scene, settings, model: NifModel, cols, rows, seed=None,
                          *, noise=None, width: int, height: int, max_path_length: int,
                          aa_noise_type: str = "normal") -> MegaStepOut:
    """Plain PyTorch version of the megastep: trace + env shade per sample."""
    if cols.is_cuda:
        render_megastep_plain.cuda_runs += 1
    n = cols.shape[0]
    dev = cols.device
    rad = Vec3.zeros((n,), device=dev)
    plen = torch.zeros(n, dtype=torch.int32, device=dev)
    for s in range(_samples(settings, noise)):
        st = trace_sample_plain(
            scene, settings, cols, rows, seed, noise=None if noise is None else noise[s],
            sample_index=s, width=width, height=height,
            max_path_length=max_path_length, aa_noise_type=aa_noise_type)
        env = nif_env_shade_plain(model, st.esc_dir, st.esc_w, settings.azimuth)
        rad = rad + (st.radiance + env)
        plen = plen + st.path_len
    return MegaStepOut(rad, plen)


render_megastep_plain.cuda_runs = 0


def render_megastep(scene: Scene, settings, model: NifModel, cols, rows, seed=None, *,
                    noise=None, width: int, height: int, max_path_length: int,
                    aa_noise_type: str = "normal", budgets=None, with_stats: bool = False,
                    env_skip: bool = False, sobol=None, stub: str | None = None
                    ) -> MegaStepOut:
    """Render ``settings.samples_per_step`` samples (hardware mode, seed
    words ``seed``) or ``noise.shape[0]`` samples (host noise) of every
    pixel: the kernel for CUDA tensors, the plain version for CPU."""
    if (seed is None) == (noise is None):
        raise ValueError("pass exactly one of seed= or noise=")
    for name, on, item in (("budgets", budgets is not None, "queue 1 item 9"),
                           ("with_stats", with_stats, "queue 1 item 9"),
                           ("env_skip", env_skip, "queue 1 item 11"),
                           ("sobol", sobol is not None, "queue 1 item 10"),
                           ("stub", bool(stub), "queue 1 item 16")):
        if on:
            raise NotImplementedError(
                f"megastep mode '{name}' is not ported yet (ROADMAP.md {item})")
    kw = dict(width=width, height=height, max_path_length=max_path_length,
              aa_noise_type=aa_noise_type)
    if cols.device.type == "cpu":
        return render_megastep_plain(scene, settings, model, cols, rows, seed,
                                     noise=noise, **kw)
    n = cols.shape[0]
    samples = _samples(settings, noise)
    operands = [cols, rows] + ([] if noise is None else [noise])
    dev = _lib.require_cuda("megastep", *operands, *model_tensors(model))
    if cols.dtype != torch.float32 or rows.dtype != torch.float32 or rows.shape != (n,):
        raise ValueError("megastep: cols/rows must be (P,) float32")
    if noise is not None and (noise.dtype != torch.float32 or noise.shape
                              != (samples, 4 + 4 * max_path_length, n)):
        raise ValueError("megastep: noise must be (S, 4 + 4L, P) float32")
    prm = trace_params(scene, settings, seed=seed, device=dev, **kw)
    net = net_struct(model)
    sph, dsc = pack_scene(scene.to(dev))
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    plen = torch.empty(n, dtype=torch.int32, device=dev)
    err = _lib.library().pt_megastep(
        ctypes.byref(prm), ctypes.byref(net), _lib.ptr(sph), _lib.ptr(dsc),
        _lib.ptr(cols), _lib.ptr(rows), _lib.ptr(noise), samples, n, _lib.ptr(rad),
        _lib.ptr(plen), _lib.stream(dev))
    _lib.check(err, "megastep")
    render_megastep.launches += 1
    return MegaStepOut(Vec3.unstack(rad), plen)


render_megastep.launches = 0
