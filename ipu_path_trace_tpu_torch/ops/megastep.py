"""K3: the megastep kernel - a whole render step (sample loop, trace and
NIF env shade) in one launch.

Replaces ``ipu_path_trace_tpu/ops/megastep_pallas.py::render_megastep_pallas``
(``csrc/megastep.cu``).  ``render_megastep`` launches it for CUDA tensors
and runs ``render_megastep_plain`` - the per-sample composition of the
plain trace (ops/trace.py) and the plain env shade (ops/nif.py) - for CPU
tensors.  Returns the SUM over the step's samples of radiance (env light
applied) and of path length.

Modes, as the reference kernel's: hardware (Philox, ``seed``), host noise
(``noise`` of shape (S, 4 + 4L, P)) and Owen-Sobol (``seed`` with
``sobol=(pixel_id, base, key)``, ``sobol_dims``), each with the bf16
chain (``NifModel``) or the int8 chain (``QuantNifModel``); per-block
sample ``budgets`` (adaptive sampling), ``with_stats`` (the per-record
sum of squared sample luminance, ``lum2``) and ``env_skip`` (the NIF
chain skipped for sub-tiles with no escape).  The measurement stubs
(``stub``) raise NotImplementedError (ROADMAP queue 1 item 16).
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
from .trace import check_sobol, pack_scene, trace_params, trace_sample_plain

# Rays that share one sample budget (render/adaptive.py reads it from
# here): the reference's tuned TPU block, so the controller allocates at
# the reference's granularity.  A multiple of the kernel's 256-ray CUDA
# block, whose NIF chain ends in block barriers and so needs one budget
# for all its rays.
BUDGET_BLOCK = 2048
RAYS_PER_CUDA_BLOCK = 256  # csrc/megastep.cu kRaysPerBlock
# Rays per NIF sub-tile (csrc/nif_dev.cuh kTile): the env-skip guard's
# granularity, at which render/wavefront.dead_block_fraction measures.
ENV_SKIP_TILE = 64

# Rec.709 luma weights of the statistics (the reference's LUM_R/G/B).
LUM_R, LUM_G, LUM_B = 0.2126, 0.7152, 0.0722


class MegaStepOut(NamedTuple):
    radiance: Vec3  # per-pixel radiance sum over the step's samples
    path_len: torch.Tensor  # int32 path-length sum
    # Sum over samples of luminance(sample radiance)^2 (with_stats=True),
    # the second moment of render/adaptive.compute_budgets; else None.
    lum2: torch.Tensor | None = None


def luminance(rad: Vec3) -> torch.Tensor:
    return LUM_R * rad.x + LUM_G * rad.y + LUM_B * rad.z


def _samples(settings, noise) -> int:
    return settings.samples_per_step if noise is None else noise.shape[0]


def _check_budgets(budgets, budget_block: int, n: int, device) -> None:
    if budgets is None:
        return
    if budget_block <= 0 or budget_block % RAYS_PER_CUDA_BLOCK:
        raise ValueError(f"budget_block {budget_block} must be a positive multiple of "
                         f"{RAYS_PER_CUDA_BLOCK}")
    groups = -(-n // budget_block)
    if budgets.dtype != torch.int32 or budgets.shape != (groups,) or budgets.device != device:
        raise ValueError(f"budgets must be ({groups},) int32 on {device}, one per "
                         f"{budget_block} rays")


def render_megastep_plain(scene: Scene, settings, model: NifModel, cols, rows, seed=None,
                          *, noise=None, width: int, height: int, max_path_length: int,
                          aa_noise_type: str = "normal", budgets=None,
                          budget_block: int = BUDGET_BLOCK, with_stats: bool = False,
                          env_skip: bool = False, sobol=None,
                          sobol_dims: int = 0) -> MegaStepOut:
    """Plain PyTorch version of the megastep: trace + env shade per sample.

    ``budgets`` bound each block's sample loop (lanes past their budget
    add nothing; with host noise the loop also stops at its S rows).
    ``env_skip`` changes nothing here: the kernel's skip is exact."""
    del env_skip
    if cols.is_cuda:
        render_megastep_plain.cuda_runs += 1
    n = cols.shape[0]
    dev = cols.device
    rad = Vec3.zeros((n,), device=dev)
    plen = torch.zeros(n, dtype=torch.int32, device=dev)
    lum2 = torch.zeros(n, dtype=torch.float32, device=dev) if with_stats else None
    samples = _samples(settings, noise)
    lane_budget = None
    if budgets is not None:
        lane_budget = budgets.repeat_interleave(budget_block)[:n]
        if noise is None:
            samples = int(budgets.max()) if n else 0
    for s in range(samples):
        st = trace_sample_plain(
            scene, settings, cols, rows, seed, noise=None if noise is None else noise[s],
            sample_index=s, width=width, height=height,
            max_path_length=max_path_length, aa_noise_type=aa_noise_type, sobol=sobol,
            sobol_dims=sobol_dims)
        env = nif_env_shade_plain(model, st.esc_dir, st.esc_w, settings.azimuth)
        total, path_len = st.radiance + env, st.path_len
        if lane_budget is not None:
            on = s < lane_budget
            total = total.where(on, Vec3.zeros((n,), device=dev))
            path_len = torch.where(on, path_len, torch.zeros_like(path_len))
        rad = rad + total
        plen = plen + path_len
        if with_stats:
            lum = luminance(total)
            lum2 = lum2 + lum * lum
    return MegaStepOut(rad, plen, lum2)


render_megastep_plain.cuda_runs = 0


def render_megastep(scene: Scene, settings, model: NifModel, cols, rows, seed=None, *,
                    noise=None, width: int, height: int, max_path_length: int,
                    aa_noise_type: str = "normal", budgets=None,
                    budget_block: int = BUDGET_BLOCK, with_stats: bool = False,
                    env_skip: bool = False, sobol=None, sobol_dims: int = 0,
                    stub: str | None = None) -> MegaStepOut:
    """Render ``settings.samples_per_step`` samples (hardware mode, seed
    words ``seed``), ``noise.shape[0]`` samples (host noise) or
    ``budgets[g]`` samples for the rays of budget block g (``budgets``:
    (ceil(P / budget_block),) int32; with host noise S must cover them) of
    every pixel: the kernel for CUDA tensors, the plain version for CPU."""
    if (seed is None) == (noise is None):
        raise ValueError("pass exactly one of seed= or noise=")
    if stub:
        raise NotImplementedError(
            "megastep mode 'stub' is not ported yet (ROADMAP.md queue 1 item 16)")
    n = cols.shape[0]
    check_sobol(sobol, sobol_dims, max_path_length, seed, n)
    _check_budgets(budgets, budget_block, n, cols.device)
    kw = dict(width=width, height=height, max_path_length=max_path_length,
              aa_noise_type=aa_noise_type, budgets=budgets, budget_block=budget_block,
              with_stats=with_stats, env_skip=env_skip, sobol=sobol, sobol_dims=sobol_dims)
    if cols.device.type == "cpu":
        return render_megastep_plain(scene, settings, model, cols, rows, seed,
                                     noise=noise, **kw)
    samples = _samples(settings, noise)
    operands = [cols, rows] + ([] if noise is None else [noise]) + (
        [] if sobol is None else list(sobol[:2])) + ([] if budgets is None else [budgets])
    dev = _lib.require_cuda("megastep", *operands, *model_tensors(model))
    if cols.dtype != torch.float32 or rows.dtype != torch.float32 or rows.shape != (n,):
        raise ValueError("megastep: cols/rows must be (P,) float32")
    if noise is not None and (noise.dtype != torch.float32 or noise.shape
                              != (samples, 4 + 4 * max_path_length, n)):
        raise ValueError("megastep: noise must be (S, 4 + 4L, P) float32")
    prm = trace_params(scene, settings, seed=seed, device=dev, sobol=sobol,
                       sobol_dims=sobol_dims, width=width, height=height,
                       max_path_length=max_path_length, aa_noise_type=aa_noise_type)
    net = net_struct(model)
    sph, dsc = pack_scene(scene.to(dev))
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    plen = torch.empty(n, dtype=torch.int32, device=dev)
    lum2 = torch.empty(n, dtype=torch.float32, device=dev) if with_stats else None
    pid, base = (None, None) if sobol is None else sobol[:2]
    err = _lib.library().pt_megastep(
        ctypes.byref(prm), ctypes.byref(net), _lib.ptr(sph), _lib.ptr(dsc),
        _lib.ptr(cols), _lib.ptr(rows), _lib.ptr(noise), _lib.ptr(pid), _lib.ptr(base),
        _lib.ptr(budgets), budget_block, samples, n, int(bool(env_skip)), _lib.ptr(rad),
        _lib.ptr(plen), _lib.ptr(lum2), _lib.stream(dev))
    _lib.check(err, "megastep")
    render_megastep.launches += 1
    return MegaStepOut(Vec3.unstack(rad), plen, lum2)


render_megastep.launches = 0
