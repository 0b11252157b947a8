"""K3: the megastep kernel - a whole render step (sample loop, trace and
NIF env shade) in one launch.

Replaces ``ipu_path_trace_tpu/ops/megastep_pallas.py::render_megastep_pallas``
(``csrc/megastep.cuh``).  ``render_megastep`` launches it for CUDA tensors
and runs ``render_megastep_plain`` - the per-sample composition of the
plain trace (ops/trace.py) and the plain env shade (ops/nif.py) - for CPU
tensors.  Returns the SUM over the step's samples of radiance (env light
applied) and of path length.

Modes, as the reference kernel's: hardware (Philox, ``seed``), host noise
(``noise`` of shape (S, 4 + 4L, P)) and Owen-Sobol (``seed`` with
``sobol=(pixel_id, base, key)``, ``sobol_dims``), each with the bf16
chain (``NifModel``) or the int8 chain (``QuantNifModel``), both
``megastep_wg_kernel`` on the ``wgmma`` chains of ``csrc/nif_wgmma.cuh``
under ``megastep_wg_plan``; per-block sample ``budgets`` (adaptive
sampling), ``with_stats`` (the per-record sum of squared sample
luminance, ``lum2``) and ``env_skip`` (the NIF chain skipped for
128-ray tiles with no escape, ``ENV_SKIP_TILE``).
For a CUDA tensor there is no fallback: a plan, build or launch that
fails raises.  The measurement stubs of
--device-timing (``stub``, utils/devtime.py) are the reference's:
``'nif'`` replaces every layer's product by ones (no bias) and decodes
them, ``'trace'`` replaces each bounce by ``path_len += (rr < 2)`` (rays
never die, radiance and escapes stay zero; the chain still runs on the
zero escapes), ``'both'`` does both.  Their kernels are built for the
Philox and Sobol modes (``csrc/megastep_stub.cu``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.scene import Scene
from ..core.vecmath import Vec3
from ..models.nif import NifModel
from ..models.quant import QuantNifModel
from . import _lib
from .nif import WG_RAYS, model_tensors, nif_env_shade_plain, wg_arg, wg_struct, wgmma_plan
from .trace import (TraceOut, check_mode, pack_scene, sample_rows, trace_params,
                    trace_sample_plain)

# Rays that share one sample budget (render/adaptive.py reads it from
# here): the reference's tuned TPU block, so the controller allocates at
# the reference's granularity.  A multiple of the kernels' 256-ray CUDA
# block, whose NIF chain needs one budget for all its rays: block-wide
# barriers, and both consumer warpgroups taking every weight slice.
BUDGET_BLOCK = 2048
RAYS_PER_CUDA_BLOCK = 256  # csrc/megastep.cuh kRaysPerBlock: two 128-ray wgmma tiles
# Rays per env-skip tile, the guard's granularity, at which
# render/wavefront.dead_block_fraction measures: the wgmma tile of either
# chain.
ENV_SKIP_TILE = WG_RAYS
# The kernel's tail of the chain's shared-memory plan
# (csrc/megastep.cuh kMegaUvBytes, kMegaOutBytes, kMegaCtlBytes): the
# block's (u, v), the head's 3 outputs per ray, the control word; the
# scene's tables follow.
MEGA_TAIL_BYTES = (2 + 3) * RAYS_PER_CUDA_BLOCK * 4 + 16

# The measurement stubs (csrc/megastep.cuh StubMode).
STUBS = {"nif": 1, "trace": 2, "both": 3}

# Rec.709 luma weights of the statistics (the reference's LUM_R/G/B).
LUM_R, LUM_G, LUM_B = 0.2126, 0.7152, 0.0722


class MegaStepOut(NamedTuple):
    radiance: Vec3  # per-pixel radiance sum over the step's samples
    path_len: torch.Tensor  # int32 path-length sum
    # Sum over samples of luminance(sample radiance)^2 (with_stats=True),
    # the second moment of render/adaptive.compute_budgets; else None.
    lum2: torch.Tensor | None = None


def table_bytes(scene: Scene) -> int:
    """Bytes of the scene's tables in shared memory (csrc/common.cuh
    tables_bytes: 12 floats per sphere, 15 per disc)."""
    return 4 * (12 * scene.num_spheres + 15 * scene.num_discs)


def megastep_wg_plan(model: NifModel, scene: Scene) -> dict:
    """The kernel's shared-memory plan: the ``wgmma`` chain's
    (ops/nif.wgmma_plan, bf16 or int8) with K3's tail from ``smem_uv`` on -
    the block's (u, v), the head's outputs and the control word
    (MEGA_TAIL_BYTES), then the scene's tables at ``smem_tables``, 16-byte
    aligned - and as many ring stages as then fit (at most 4; 3 bf16 and 4
    int8 for the canonical net and the default scene).  Raises ValueError,
    naming the limit, where not even two stages fit."""
    tables = -(-table_bytes(scene) // 16) * 16
    chain = "int8" if isinstance(model, QuantNifModel) else "bf16"
    plan = wgmma_plan(model, MEGA_TAIL_BYTES + tables,
                      f"the megastep's {chain} chain with {tables} B of scene tables")
    plan["smem_tables"] = plan["smem_uv"] + MEGA_TAIL_BYTES
    return plan


def kernel_net(model: NifModel, scene: Scene):
    """The NifWg of the model's chain (bf16 or int8) under
    ``megastep_wg_plan``."""
    return wg_struct(model, megastep_wg_plan(model, scene))


def luminance(rad: Vec3) -> torch.Tensor:
    return LUM_R * rad.x + LUM_G * rad.y + LUM_B * rad.z


def _samples(settings, noise) -> int:
    return settings.samples_per_step if noise is None else noise.shape[0]


def _stub_trace_plain(rows: torch.Tensor, max_path_length: int) -> TraceOut:
    """The stubbed trace of one sample (megastep_pallas.py::_stub_bounce)
    from its noise rows: each bounce adds (rr < 2) to the path length."""
    n, dev = rows.shape[1], rows.device
    zero = Vec3.zeros((n,), device=dev)
    rr = rows[4:4 + 4 * max_path_length:4]
    return TraceOut(zero, zero, zero, torch.zeros(n, dtype=torch.bool, device=dev),
                    (rr < 2.0).sum(dim=0, dtype=torch.int32))


def _stub_env_plain(model: NifModel, esc_w: Vec3) -> Vec3:
    """The stubbed env term (megastep_pallas.py::_stub_nif_layer): the
    decode of ones, y = max + mean (exp if log), times the flipped escape
    weights."""
    y = (torch.ones(3, dtype=torch.float32, device=esc_w.x.device) * model.max
         + torch.tensor(model.mean, dtype=torch.float32, device=esc_w.x.device))
    out = torch.exp(y) if model.log_tone_map else y
    return Vec3(esc_w.x * out[2], esc_w.y * out[1], esc_w.z * out[0])


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
                          sobol_dims: int = 0, stub: str | None = None) -> MegaStepOut:
    """Plain PyTorch version of the megastep: trace + env shade per sample.

    ``budgets`` bound each block's sample loop (lanes past their budget
    add nothing; with host noise the loop also stops at its S rows).
    ``env_skip`` changes nothing here: the kernel's skip is exact.
    ``stub`` replaces the trace, the chain or both (module docstring)."""
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
        sample_noise = None if noise is None else noise[s]
        if stub in ("trace", "both"):
            st = _stub_trace_plain(sample_rows(seed, sample_noise, s, n, max_path_length,
                                               aa_noise_type, dev, sobol, sobol_dims),
                                   max_path_length)
        else:
            st = trace_sample_plain(
                scene, settings, cols, rows, seed, noise=sample_noise, sample_index=s,
                width=width, height=height, max_path_length=max_path_length,
                aa_noise_type=aa_noise_type, sobol=sobol, sobol_dims=sobol_dims)
        if stub in ("nif", "both"):
            env = _stub_env_plain(model, st.esc_w)
        else:
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
    every pixel: the kernel for CUDA tensors, the plain version for CPU.
    ``stub`` ('nif', 'trace' or 'both') runs a measurement stub."""
    stub = stub or None
    if stub is not None and stub not in STUBS:
        raise ValueError(f"unknown megastep stub {stub!r} (choices: {', '.join(STUBS)})")
    n = cols.shape[0]
    check_mode(seed, noise, sobol, sobol_dims, max_path_length, n)
    _check_budgets(budgets, budget_block, n, cols.device)
    kw = dict(width=width, height=height, max_path_length=max_path_length,
              aa_noise_type=aa_noise_type, budgets=budgets, budget_block=budget_block,
              with_stats=with_stats, env_skip=env_skip, sobol=sobol, sobol_dims=sobol_dims,
              stub=stub)
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
    if stub is not None and noise is not None:
        raise ValueError("megastep: the stub kernels are built for the Philox and Sobol "
                         "modes, not host noise")
    prm = trace_params(scene, settings, seed=seed, device=dev, sobol=sobol,
                       sobol_dims=sobol_dims, width=width, height=height,
                       max_path_length=max_path_length, aa_noise_type=aa_noise_type)
    wg = wg_arg(kernel_net(model, scene))
    sph, dsc = pack_scene(scene, dev)
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    plen = torch.empty(n, dtype=torch.int32, device=dev)
    lum2 = torch.empty(n, dtype=torch.float32, device=dev) if with_stats else None
    pid, base = (None, None) if sobol is None else sobol[:2]
    lib = _lib.library()
    common = (_lib.ptr(sph), _lib.ptr(dsc), _lib.ptr(cols), _lib.ptr(rows))
    tail = (_lib.ptr(pid), _lib.ptr(base), _lib.ptr(budgets), budget_block, samples, n,
            int(bool(env_skip)), _lib.ptr(rad), _lib.ptr(plen), _lib.ptr(lum2))
    if stub is None:
        err = lib.pt_megastep(ctypes.byref(prm), wg, *common, _lib.ptr(noise), *tail,
                              _lib.stream(dev))
    else:
        err = lib.pt_megastep_stub(ctypes.byref(prm), wg, *common, *tail, STUBS[stub],
                                   _lib.stream(dev))
    _lib.check(err, "megastep" if stub is None else f"megastep stub '{stub}'")
    if stub is None:
        render_megastep.launches += 1
    else:
        render_megastep.stub_launches[stub] += 1
    return MegaStepOut(Vec3.unstack(rad), plen, lum2)


render_megastep.launches = 0  # the production kernels
render_megastep.stub_launches = dict.fromkeys(STUBS, 0)
