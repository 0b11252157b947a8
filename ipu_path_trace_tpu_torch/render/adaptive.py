"""Adaptive per-block sampling: spend samples where the variance is.

Counterpart of ``ipu_path_trace_tpu/render/adaptive.py``.  The megastep
kernel accumulates, per record, the second moment of per-sample luminance
(``with_stats``); ``compute_budgets`` turns the accumulated first and
second moments into a per-block variance estimate and allocates the next
step's per-block sample budgets by Neyman allocation (proportional to the
block's luminance standard deviation), floored, capped and redistributed
once; the megastep then runs each block's sample loop to its own budget.
The controller is plain PyTorch on the worklist's device, so the whole
step stays on the device (it needs ``--device-film``: the film divides
every record by its own int32 count, which keeps the estimator unbiased).

The budget block is ``ops/megastep.BUDGET_BLOCK`` rays: the controller
and the kernel must agree on it, so it is defined once, there.
Budgets are a pure function of the accumulated state, so a rerun
replays them exactly.
"""

from __future__ import annotations

import torch

from ..core.records import WorkBatch
from ..ops.megastep import BUDGET_BLOCK, LUM_B, LUM_G, LUM_R
from ..utils.tracing import span
from .params import RenderSettings, StaticConfig


def _f32(x) -> torch.Tensor:
    """An f32 scalar on the host: a CUDA op takes it as an argument, so
    no copy to the card waits for the stream."""
    return torch.tensor(float(x), dtype=torch.float32)


def compute_budgets(r, g, b, lum2, sample_count, *, block_size: int, samples_per_step: int,
                    min_spp: int, max_spp: int) -> torch.Tensor:
    """Per-block sample budgets for the next step, (G,) int32.

    Per record, var_i = E[l^2] - E[l]^2 from the accumulated sums; blocks
    are scored by sigma_g = sqrt(sum_i var_i) and budgets allocated in
    proportion (Neyman), floored at ``min_spp``, capped at ``max_spp``
    with one redistribution pass, and rounded.  The total is G *
    samples_per_step.  Cold start (no samples) or a frame with zero
    variance falls back to the uniform budget.  The f32 arithmetic is the
    reference's, operation for operation.
    """
    dev = r.device
    p = r.shape[0]
    pad = (-p) % block_size
    nf = torch.clamp_min(sample_count.to(torch.float32), 1.0)
    lum_mean = (LUM_R * r + LUM_G * g + LUM_B * b) / nf
    var = torch.clamp_min(lum2 / nf - lum_mean * lum_mean, 0.0)
    if pad:
        var = torch.nn.functional.pad(var, (0, pad))
    vb = var.reshape(-1, block_size).sum(dim=1)  # (G,)
    n_blocks = vb.shape[0]
    sigma = torch.sqrt(vb)

    spp_f, max_f, min_f = (_f32(x) for x in (samples_per_step, max_spp, min_spp))
    total = spp_f * n_blocks
    extra = total - min_f * n_blocks  # to distribute by score
    w = sigma / torch.clamp_min(sigma.sum(), 1e-30)
    raw = min_f + w * extra
    capped = torch.minimum(raw, max_f)
    # One redistribution pass: what the cap clipped goes to the uncapped
    # blocks by score (never to zero-variance blocks); what the spill
    # itself pushes past the cap is dropped, not re-spilled.
    shortfall = torch.clamp_min(raw - capped, 0.0).sum()
    spill_w = torch.where(raw < max_f, sigma, torch.zeros_like(sigma))
    spill_w = spill_w / torch.clamp_min(spill_w.sum(), 1e-30)
    capped = torch.minimum(capped + spill_w * shortfall, max_f)
    budgets = torch.minimum(torch.maximum(torch.round(capped), min_f), max_f).to(torch.int32)

    uniform = torch.full((n_blocks,), int(samples_per_step), dtype=torch.int32, device=dev)
    # f32 sum: an int32 count sum wraps on long renders.
    fallback = (sample_count.to(torch.float32).sum() == 0.0) | (sigma.sum() <= 0.0)
    return torch.where(fallback, uniform, budgets)


def adaptive_caps(cfg: StaticConfig, spp: int) -> tuple[int, int]:
    """(min, max) per-block budget: the floor never exceeds the average,
    the cap is round(factor * spp), at least spp."""
    cap = max(int(torch.round(_f32(cfg.adaptive_max_factor) * spp)), spp)
    return min(cfg.adaptive_min, spp), cap


def adaptive_render_step(scene, settings: RenderSettings, cfg: StaticConfig, work: WorkBatch,
                         lum2: torch.Tensor, seed: tuple[int, int] | None, env, *, noise=None,
                         block_size: int = BUDGET_BLOCK,
                         sample_axis_index: int = 0) -> tuple[WorkBatch, torch.Tensor]:
    """One adaptive render step; returns (work', lum2').

    Budgets derive from the accumulated state (the work sums and
    ``lum2``), then the fused megastep renders budgets[g] samples for the
    rays of block g with the statistics on.  Hardware mode (``seed``) or
    host noise (``noise`` of shape (S, 4 + 4L, P), S at least the budget
    cap; rows past a block's budget are gated off).  The Sobol sampler
    continues each lane at its own count (``work.sample_count``); replica j
    of a mesh's sample axis (``sample_axis_index``) at that count plus j x
    its block's budget, so the replicas, whose moments and so budgets are
    the same, draw disjoint slices.
    """
    from ..models.envlight import NifEnv
    from ..ops.megastep import render_megastep
    from .wavefront import _kernel_sobol, make_qmc_ctx

    if not isinstance(env, NifEnv):
        raise ValueError("adaptive sampling requires the NIF environment light "
                         "(the fused megastep)")
    if not cfg.use_fused_step:
        raise ValueError("adaptive sampling requires the fused megastep")
    spp = settings.samples_per_step
    min_spp, cap = adaptive_caps(cfg, spp)
    if noise is not None and noise.shape[0] < cap:
        raise ValueError(f"host noise must cover the budget cap ({cap} samples)")
    with span("compute_budgets"):
        budgets = compute_budgets(work.r, work.g, work.b, lum2, work.sample_count,
                                  block_size=block_size, samples_per_step=spp,
                                  min_spp=min_spp, max_spp=cap)
    inc = budgets.repeat_interleave(block_size)[:work.u.shape[0]]
    ctx = None if noise is not None else make_qmc_ctx(work, cfg, settings)
    if ctx is not None and sample_axis_index:
        ctx = ctx._replace(base=ctx.base + sample_axis_index * inc)
    kw = _kernel_sobol(cfg, ctx)
    out = render_megastep(
        scene, settings, env.model, work.u.to(torch.float32), work.v.to(torch.float32), seed,
        noise=noise, width=cfg.width, height=cfg.height, max_path_length=cfg.max_path_length,
        aa_noise_type=cfg.aa_noise_type, budgets=budgets, budget_block=block_size,
        with_stats=True, **kw)
    new_work = WorkBatch(
        u=work.u, v=work.v,
        r=work.r + out.radiance.x, g=work.g + out.radiance.y, b=work.b + out.radiance.z,
        sample_count=work.sample_count + inc,
        path_length=work.path_length + out.path_len)
    return new_work, lum2 + out.lum2
