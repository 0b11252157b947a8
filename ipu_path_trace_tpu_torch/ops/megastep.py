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
chain (a bf16 ``NifModel``), the f32 chain on TF32 ``wgmma`` (an f32
``NifModel``, ``--partials-type float``) or the int8 chain
(``QuantNifModel``), all ``megastep_wg_kernel`` on the ``wgmma`` chains
of ``csrc/nif_wgmma.cuh`` under ``megastep_wg_plan``; per-block sample
``budgets`` (adaptive sampling) and ``with_stats`` (the per-record sum of
squared sample luminance, ``lum2``).  Each CUDA block queues the escapes
of its samples and runs the NIF chain on full tiles of them (128 rays,
64 for the f32 chain: ``chain_tile``), the last partial tile after its
last sample; a ray that does not escape is never shaded, so the
reference's skip of a tile with no escape has nothing left to skip.
Which rays a CUDA block takes: a launch without budgets maps block b to
rays 256 b.. 256 b + 255.  A launch with budgets dispatches its 256-ray
blocks heaviest budget first: it sorts them on the device
(``block_order``, no host sync) and passes that order with a ticket
counter; each CUDA block takes the next ticket t and the rays of block
``order[t]``, so the longest budgets start in the first wave and the
short ones fill in behind them (``render_megastep.ordered_launches``
counts these launches).  Each ray computes what it computes in index
order, so the outputs are the same bit for bit.
For a CUDA tensor there is no fallback: a plan, build or launch that
fails raises.  While tracing is on (utils/tracing.py: a render loop's
channel is current and a profiler records) each launch also writes one
record a CUDA block - its start and end on %globaltimer, its SM, its live
and escaped lane-samples, the queue's tiles it shaded, and its trace phase's
time, lane-iterations and bounces - into a buffer handed to the channel,
which reduces it when the loop ends.  The measurement stubs of
--device-timing (``stub``, utils/devtime.py) are the reference's:
``'nif'`` replaces every layer's product by ones (no bias) and decodes
them, ``'trace'`` replaces each bounce by ``path_len += (rr < 2)`` (rays
never die, radiance and escapes stay zero; every live lane is queued,
so the chain still runs on the zero escapes), ``'both'`` does both.
Their kernels are built for the Philox and Sobol modes
(``csrc/megastep_stub.cu``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.scene import Scene
from ..core.vecmath import Vec3
from ..models.nif import NifModel
from ..utils import tracing
from . import _lib
from .nif import (WG_RAYS, _elem, chain_name, model_tensors, nif_env_shade_plain, tile_rays,
                  wg_arg, wg_struct, wgmma_plan)
from .trace import (TraceOut, check_mode, pack_scene, sample_rows, trace_params,
                    trace_sample_plain)

# Rays that share one sample budget (render/adaptive.py reads it from
# here): the reference's tuned TPU block, so the controller allocates at
# the reference's granularity.  A multiple of the kernels' 256-ray CUDA
# block, whose NIF chain needs one budget for all its rays: block-wide
# barriers, and both consumer warpgroups taking every weight slice.
BUDGET_BLOCK = 2048
RAYS_PER_CUDA_BLOCK = 256  # csrc/megastep.cuh kRaysPerBlock: a ray per consumer thread
# The kernel's tail of the chain's shared-memory plan
# (csrc/megastep.cuh kMegaQueueBytes, kMegaCountBytes, kMegaCtlBytes): the
# escape queue of QUEUE_ENTRIES - each entry's (u, v), escape weights and
# direct luminance as f32, and its owner, one byte - the eight consumer
# warps' counts of a sample's entries and the control word; the scene's
# tables follow.  The queue holds what is left after shading (under a
# 128-ray tile) and a sample's entries (at most 256).
QUEUE_ENTRIES = WG_RAYS + RAYS_PER_CUDA_BLOCK
MEGA_TAIL_BYTES = QUEUE_ENTRIES * ((2 + 3 + 1) * 4 + 1) + 8 * 4 + 16

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


def chain_tile(model: NifModel) -> int:
    """Rays per tile of the model's chain in K3, the escape queue's tile:
    its wgmma tile, 128 rays for bf16 and int8, 64 for the f32 chain on
    tf32."""
    return tile_rays(_elem(model))


def megastep_wg_plan(model: NifModel, scene: Scene) -> dict:
    """The kernel's shared-memory plan: the ``wgmma`` chain's
    (ops/nif.wgmma_plan, bf16, tf32 or int8) with K3's tail from
    ``smem_uv`` on - the escape queue, the warps' counts and the control
    word (MEGA_TAIL_BYTES, 9,648 B), then the scene's tables at
    ``smem_tables``, 16-byte aligned - and as many ring stages as then fit
    (at most 4).  For the canonical 6x320 net that is 3 bf16 and tf32 and
    4 int8 with every scene of ``assets/scenes/``; 3 bf16 stages leave
    room for 528 B of tables (11 spheres), 2 for 41,488 B.  Raises
    ValueError, naming the limit, where not even two stages fit."""
    tables = -(-table_bytes(scene) // 16) * 16
    plan = wgmma_plan(model, MEGA_TAIL_BYTES + tables,
                      f"the megastep's {chain_name(model)} chain with {tables} B of scene "
                      f"tables")
    plan["smem_tables"] = plan["smem_uv"] + MEGA_TAIL_BYTES
    return plan


def kernel_net(model: NifModel, scene: Scene):
    """The NifWg of the model's chain (bf16, tf32 or int8) under
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


def block_order(budgets: torch.Tensor, n: int, budget_block: int = BUDGET_BLOCK) -> torch.Tensor:
    """The order in which an adaptive K3 launch dispatches its 256-ray
    blocks: by budget, highest first, ties in block index order (a stable
    sort, so uniform budgets give the identity).  Block k has the budget of
    group k x 256 // budget_block; the ragged last block, fewer than 256
    rays, is one block.  (ceil(n / 256),) int32 on the budgets' device, in
    torch ops alone (on a CUDA tensor: on its stream, with no sync)."""
    blocks = -(-n // RAYS_PER_CUDA_BLOCK)
    per_group = budget_block // RAYS_PER_CUDA_BLOCK
    block_budget = budgets.repeat_interleave(per_group, output_size=len(budgets) * per_group)
    return torch.sort(block_budget[:blocks], descending=True, stable=True).indices.to(torch.int32)


def render_megastep_plain(scene: Scene, settings, model: NifModel, cols, rows, seed=None,
                          *, noise=None, width: int, height: int, max_path_length: int,
                          aa_noise_type: str = "normal", budgets=None,
                          budget_block: int = BUDGET_BLOCK, with_stats: bool = False,
                          sobol=None, sobol_dims: int = 0,
                          stub: str | None = None) -> MegaStepOut:
    """Plain PyTorch version of the megastep: trace + env shade per sample.

    ``budgets`` bound each block's sample loop (lanes past their budget
    add nothing; with host noise the loop also stops at its S rows).
    ``stub`` replaces the trace, the chain or both (module docstring)."""
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
                    sobol=None, sobol_dims: int = 0, stub: str | None = None) -> MegaStepOut:
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
              with_stats=with_stats, sobol=sobol, sobol_dims=sobol_dims, stub=stub)
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
    with tracing.span("megastep_launch"):
        prm = trace_params(scene, settings, seed=seed, device=dev, sobol=sobol,
                           sobol_dims=sobol_dims, width=width, height=height,
                           max_path_length=max_path_length, aa_noise_type=aa_noise_type)
        wg = wg_arg(kernel_net(model, scene))
        sph, dsc = pack_scene(scene, dev)
        rad = torch.empty((3, n), dtype=torch.float32, device=dev)
        plen = torch.empty(n, dtype=torch.int32, device=dev)
        lum2 = torch.empty(n, dtype=torch.float32, device=dev) if with_stats else None
        # The per-block record (csrc/megastep.cuh), only while tracing is
        # on; zeroed, so a block that wrote none shows (tracing.launch_record).
        stamps = None
        if stub is None and tracing.tracing_on():
            stamps = torch.zeros((-(-n // RAYS_PER_CUDA_BLOCK), tracing.STAMP_WORDS),
                                 dtype=torch.int64, device=dev)
        # Heaviest budget first (module docstring); the launcher zeroes the ticket.
        order = ticket = None
        if budgets is not None:
            order = block_order(budgets, n, budget_block)
            ticket = torch.empty(1, dtype=torch.int32, device=dev)
        pid, base = (None, None) if sobol is None else sobol[:2]
        ptrs = dict(sph=sph, dsc=dsc, cols=cols, rows=rows, noise=noise, pid=pid, base=base,
                    budgets=budgets, order=order, ticket=ticket, rad=rad, plen=plen, lum2=lum2,
                    stamps=stamps)
        args = _lib.MegaArgs(budget_block=budget_block, samples=samples, n=n,
                             **{k: _lib.ptr(t) for k, t in ptrs.items()})
        with torch.cuda.device(dev):  # the launch's shared-memory attribute, SM count, stream
            err = _lib.library().pt_megastep(ctypes.byref(prm), wg, ctypes.byref(args),
                                             STUBS.get(stub, 0), _lib.stream(dev))
        _lib.check(err, "megastep" if stub is None else f"megastep stub '{stub}'")
        if stamps is not None:
            tracing.keep_launch(stamps, chain_tile(model))
    if stub is None:
        render_megastep.launches += 1
        render_megastep.ordered_launches += budgets is not None
    else:
        render_megastep.stub_launches[stub] += 1
    return MegaStepOut(Vec3.unstack(rad), plen, lum2)


render_megastep.launches = 0  # the production kernels
render_megastep.ordered_launches = 0  # those with budgets, dispatched heaviest first
render_megastep.stub_launches = dict.fromkeys(STUBS, 0)
