"""The plain reference's adaptive budget controller.

A frozen copy, operation for operation in f32, of the renderer's
controller: per record var = E[l^2] - E[l]^2 of the Rec.709 luminance
from the accumulated sums, each block of ``block_size`` records scored by
sigma = sqrt(sum var), budgets in proportion to sigma (Neyman) above a
floor, capped with one redistribution pass, rounded; a cold start or a
frame with no variance takes the uniform budget.
"""

from __future__ import annotations

import torch

LUM_R, LUM_G, LUM_B = 0.2126, 0.7152, 0.0722
BUDGET_BLOCK = 2048  # records that share one budget


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


def adaptive_caps(adaptive_min: int, adaptive_max_factor: float, spp: int) -> tuple[int, int]:
    """(floor, cap) of a block's budget a step."""
    cap = max(int(torch.round(_f32(adaptive_max_factor) * spp)), spp)
    return min(adaptive_min, spp), cap


def compute_budgets(r, g, b, lum2, sample_count, *, block_size: int, samples_per_step: int,
                    min_spp: int, max_spp: int) -> torch.Tensor:
    """(G,) int32 budgets of the next step."""
    dev = r.device
    p = r.shape[0]
    pad = (-p) % block_size
    nf = torch.clamp_min(sample_count.to(torch.float32), 1.0)
    lum_mean = (LUM_R * r + LUM_G * g + LUM_B * b) / nf
    var = torch.clamp_min(lum2 / nf - lum_mean * lum_mean, 0.0)
    if pad:
        var = torch.nn.functional.pad(var, (0, pad))
    vb = var.reshape(-1, block_size).sum(dim=1)
    n_blocks = vb.shape[0]
    sigma = torch.sqrt(vb)
    spp_f, max_f, min_f = (_f32(x) for x in (samples_per_step, max_spp, min_spp))
    total = spp_f * n_blocks
    extra = total - min_f * n_blocks
    w = sigma / torch.clamp_min(sigma.sum(), 1e-30)
    raw = min_f + w * extra
    capped = torch.minimum(raw, max_f)
    shortfall = torch.clamp_min(raw - capped, 0.0).sum()
    spill_w = torch.where(raw < max_f, sigma, torch.zeros_like(sigma))
    spill_w = spill_w / torch.clamp_min(spill_w.sum(), 1e-30)
    capped = torch.minimum(capped + spill_w * shortfall, max_f)
    budgets = torch.minimum(torch.maximum(torch.round(capped), min_f), max_f).to(torch.int32)
    uniform = torch.full((n_blocks,), int(samples_per_step), dtype=torch.int32, device=dev)
    fallback = (sample_count.to(torch.float32).sum() == 0.0) | (sigma.sum() <= 0.0)
    return torch.where(fallback, uniform, budgets)
