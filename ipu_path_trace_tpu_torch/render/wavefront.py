"""The render step and the plain (PyTorch) wavefront trace.

Counterpart of ``ipu_path_trace_tpu/render/wavefront.py``.  ``bounce_body``
and ``trace_sample_with_uniforms`` are the reference's masked-lane
wavefront over the whole batch; they are the plain version of the trace
kernel (ops/trace.py).  ``render_step`` runs one progressive step and
dispatches like the reference's ``render_step_impl``: the fused megastep
kernel when ``cfg.use_fused_step`` and the env is a NIF (bf16, f32 or int8),
with ``cfg.megastep_stub`` forwarded to it (utils/devtime.py), otherwise
the trace kernel per sample plus the env-shade kernel (NIF) or
``eval_env`` (constant or texture env, e.g. a baked NIF).

Randomness: hardware mode keys the kernels' Philox stream with two seed
words per step (sample s of the step is counter word 1 = s); host-noise
mode takes an explicit (S, 4 + 4L, P) array in the kernels' row layout
([0:2] AA jitter already distributed, [2:4] lens uniforms,
[4+4b : 8+4b] bounce b), which ``sample_noise``/``step_noise`` draw from
a ``torch.Generator``.  With ``cfg.sampler == "sobol"`` the first
``sobol_dims_used(cfg)`` rows come from each lane's Owen-scrambled Sobol
sequence (render/qmc.py) at index base + s, where base is the lane's
count of samples so far: the worklist's ``sample_count`` with the device
film, or the ``sobol_base`` the caller passes (the host film zeroes the
counts every step).  The rows past that prefix come from the Philox
stream, in the kernels and in ``sample_noise``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.camera import aa_noise, pixel_to_ray
from ..core.envmap import equirect_uv
from ..core.geometry import intersect_scene
from ..core.materials import DIFFUSE_SCALE, REFRACT_WEIGHT, reflect, refract, sample_diffuse
from ..core.records import WorkBatch
from ..core.scene import Material, Scene
from ..core.vecmath import Vec3
from ..models.envlight import NifEnv, eval_env
from .params import RenderSettings, StaticConfig


class QmcCtx(NamedTuple):
    """Per-lane context of the Owen-Sobol sampler: sample s of a step
    draws point base + s of pixel ``pixel_id``'s scrambled sequence."""

    pixel_id: torch.Tensor  # (P,) int32 v * width + u
    base: torch.Tensor  # (P,) int32 samples so far
    key: int  # uint32 render-wide scramble key (settings.sobol_key)


def make_qmc_ctx(work: WorkBatch, cfg: StaticConfig, settings: RenderSettings,
                 base=None) -> QmcCtx | None:
    """The Sobol context of a step, or None for the prng sampler;
    ``base`` (an int or (P,) tensor) overrides ``work.sample_count``."""
    if cfg.sampler != "sobol":
        return None
    pixel_id = work.v.to(torch.int32) * cfg.width + work.u.to(torch.int32)
    if base is None:
        base = work.sample_count
    if isinstance(base, int):  # filled on the device: no copy from the host
        base = torch.full_like(pixel_id, base)
    base = torch.as_tensor(base, dtype=torch.int32, device=pixel_id.device)
    return QmcCtx(pixel_id=pixel_id, base=base.expand_as(pixel_id).contiguous(),
                  key=settings.sobol_key)


def sobol_dims_used(cfg: StaticConfig) -> int:
    """Leading noise rows carried by the Sobol sequence: a whole
    number of bounces after the 4 camera dims, capped by the layout."""
    if cfg.sampler != "sobol":
        return 0
    d = max(4, (cfg.sobol_dims // 4) * 4)
    return min(d, 4 + 4 * cfg.max_path_length)


def _kernel_sobol(cfg: StaticConfig, ctx: QmcCtx | None) -> dict:
    """The kernels' Sobol arguments (empty for the prng sampler)."""
    if ctx is None:
        return {}
    return dict(sobol=(ctx.pixel_id, ctx.base, ctx.key), sobol_dims=sobol_dims_used(cfg))


def apply_thin_lens(d: Vec3, settings: RenderSettings, l1, l2) -> tuple[Vec3, Vec3]:
    """Thin-lens camera: origin jittered on a disk, refocused through the
    plane at ``focal_distance``.  Aperture 0 returns the pinhole (o, d)
    untouched, bit for bit."""
    zero = torch.zeros_like(l1)
    if not settings.aperture > 0.0:
        return Vec3(zero, zero, zero), d
    r = settings.aperture * torch.sqrt(l1)
    phi = (2.0 * math.pi) * l2
    lx = r * torch.cos(phi)
    ly = r * torch.sin(phi)
    focal = torch.tensor(settings.focal_distance, dtype=torch.float32, device=l1.device)
    t_f = focal / torch.clamp_min(-d.z, 1e-8)  # one rounding, like the kernel's
    new_d = Vec3(d.x * t_f - lx, d.y * t_f - ly, d.z * t_f).normalized()
    return Vec3(lx, ly, zero), new_d


class BounceState(NamedTuple):
    o: Vec3
    d: Vec3
    throughput: Vec3
    radiance: Vec3
    alive: torch.Tensor
    esc_dir: Vec3
    esc_w: Vec3  # throughput * rrFactor at escape (zero if not escaped)
    escaped: torch.Tensor
    path_len: torch.Tensor  # int32 pushes (reference pathLength semantics)


def initial_state(o: Vec3, d: Vec3) -> BounceState:
    n, dev = o.x.shape[0], o.x.device
    z = Vec3.zeros((n,), device=dev)
    return BounceState(
        o=o, d=d, throughput=Vec3.full((n,), 1.0, 1.0, 1.0, device=dev), radiance=z,
        alive=torch.ones(n, dtype=torch.bool, device=dev), esc_dir=z, esc_w=z,
        escaped=torch.zeros(n, dtype=torch.bool, device=dev),
        path_len=torch.zeros(n, dtype=torch.int32, device=dev))


def bounce_body(scene: Scene, settings: RenderSettings, state: BounceState,
                rnd: torch.Tensor, bounce_idx: int) -> BounceState:
    """One bounce over the whole batch with masked lanes; ``rnd`` is
    (4, n): [rr, bsdf_u1, bsdf_u2, fresnel]."""
    dev = state.o.x.device
    f32 = dict(dtype=torch.float32, device=dev)
    rr_rand, u1, u2, fresnel_rand = rnd[0], rnd[1], rnd[2], rnd[3]
    stop_prob = torch.tensor(settings.stop_prob, **f32)

    # Russian roulette from depth roulette_depth; survivors weighted 1/(1-p).
    rr_on = bounce_idx >= settings.roulette_depth
    rr_factor = 1.0 / (1.0 - stop_prob) if rr_on else torch.tensor(1.0, **f32)
    alive = state.alive & ~(rr_rand <= stop_prob) if rr_on else state.alive

    hit = intersect_scene(scene, state.o, state.d)

    escaped_now = alive & ~hit.valid
    esc_dir = state.d.where(escaped_now, state.esc_dir)
    esc_w = (state.throughput * rr_factor).where(escaped_now, state.esc_w)
    escaped = state.escaped | escaped_now

    emit_now = alive & hit.valid & hit.emissive
    emit_add = state.throughput.cwise(hit.emission) * rr_factor
    radiance = (state.radiance + emit_add).where(emit_now, state.radiance)

    alive = alive & hit.valid & ~hit.emissive

    d_diff, cos_theta = sample_diffuse(hit.normal, u1, u2)
    d_spec = reflect(state.d, hit.normal)
    d_refr, refracted = refract(state.d, hit.normal,
                                torch.tensor(settings.refractive_index, **f32), fresnel_rand)
    is_diff = hit.material == int(Material.DIFFUSE)
    is_spec = hit.material == int(Material.SPECULAR)
    new_d = d_diff.where(is_diff, d_spec.where(is_spec, d_refr))

    n = alive.shape[0]
    one = Vec3.full((n,), 1.0, 1.0, 1.0, device=dev)
    w_diff = hit.colour * (cos_theta * DIFFUSE_SCALE * rr_factor)
    w_spec = one * rr_factor
    w_refr = hit.colour.where(refracted, one) * (REFRACT_WEIGHT * rr_factor)
    scale = w_diff.where(is_diff, w_spec.where(is_spec, w_refr))

    pushed = escaped_now | emit_now | alive
    return BounceState(
        o=hit.point.where(alive, state.o),
        d=new_d.where(alive, state.d),
        throughput=state.throughput.cwise(scale).where(alive, state.throughput),
        radiance=radiance, alive=alive, esc_dir=esc_dir, esc_w=esc_w, escaped=escaped,
        path_len=state.path_len + pushed.to(torch.int32))


def trace_sample_with_uniforms(scene: Scene, settings: RenderSettings, cfg: StaticConfig,
                               cols, rows, aa, lens, uniforms) -> BounceState:
    """Unrolled trace with injected randomness: ``aa`` (2, P) distributed
    jitter, ``lens`` (2, P) uniforms, ``uniforms`` (L, 4, P) per bounce."""
    c = cols + settings.aa_scale * aa[0]
    r = rows + settings.aa_scale * aa[1]
    d = pixel_to_ray(c, r, cfg.width, cfg.height, settings.fov).normalized()
    o, d = apply_thin_lens(d, settings, lens[0], lens[1])
    state = initial_state(o, d)
    for i in range(cfg.max_path_length):
        state = bounce_body(scene, settings, state, uniforms[i], i)
    return state


def sobol_prefix(noise: torch.Tensor, ctx: QmcCtx, sample_idx: int, dims: int,
                 aa_noise_type: str) -> torch.Tensor:
    """``noise`` (4 + 4L, n) with its first ``dims`` rows replaced by the
    lanes' Sobol points base + sample_idx: the AA pair through the
    kernels' jitter transform, the lens and bounce rows as they are."""
    from ..ops.trace import draw_aa_jitter
    from .qmc import sobol_uniforms

    us = sobol_uniforms(ctx.base + sample_idx, ctx.pixel_id, ctx.key, range(dims))
    a1, a2 = draw_aa_jitter(us[0], us[1], aa_noise_type)
    return torch.cat([torch.stack([a1, a2, *us[2:]]), noise[dims:]])


def sample_noise(source, n: int, cfg: StaticConfig, device="cpu", qmc_ctx: QmcCtx | None = None,
                 sample_idx: int = 0) -> torch.Tensor:
    """(4 + 4L, n) noise for one sample in the kernels' row layout.

    ``source`` is a ``torch.Generator`` (a CPU generator; host noise moved
    to ``device``) or two seed words (the Philox stream's sample
    ``sample_idx``, as the kernels draw it).  With ``qmc_ctx`` the first
    ``sobol_dims_used(cfg)`` rows are the lanes' Sobol points."""
    from ..ops.trace import philox_noise

    if isinstance(source, torch.Generator):
        aa = aa_noise(source, (2, n), cfg.aa_noise_type)
        rest = torch.rand((2 + 4 * cfg.max_path_length, n), generator=source)
        noise = torch.cat([aa, rest]).to(device)
    else:
        noise = philox_noise(source, sample_idx, n, cfg.max_path_length, cfg.aa_noise_type,
                             device)
    dims = sobol_dims_used(cfg) if qmc_ctx is not None else 0
    if dims:
        noise = sobol_prefix(noise, qmc_ctx, sample_idx, dims, cfg.aa_noise_type)
    return noise


def step_noise(gen: torch.Generator, n: int, cfg: StaticConfig, samples: int,
               device="cpu", qmc_ctx: QmcCtx | None = None) -> torch.Tensor:
    """(S, 4 + 4L, n) host noise for ``samples`` samples (with Sobol rows
    when ``qmc_ctx`` is given)."""
    return torch.stack([sample_noise(gen, n, cfg, device, qmc_ctx, s) for s in range(samples)])


def _check_ported(cfg: StaticConfig) -> None:
    """Refuse the reference's XLA-path switches, as the CLI does: the port
    always runs its kernels, and takes explicit host noise (``noise=``) in
    place of interpret mode (ROADMAP.md queue 1 item 20)."""
    for name, on, why in (
            ("use_pallas=False", not cfg.use_pallas,
             "the port always runs its kernels (the plain versions on the CPU)"),
            ("pallas_interpret", cfg.pallas_interpret > 0,
             "pass host noise as noise= instead")):
        if on:
            raise ValueError(f"{name} is refused: {why} (ROADMAP.md queue 1 item 20)")


def render_step(scene: Scene, settings: RenderSettings, cfg: StaticConfig, work: WorkBatch,
                seed: tuple[int, int] | None, env, *, noise=None, sobol_base=None,
                sample_axis_index: int = 0) -> WorkBatch:
    """Run one step's samples over the worklist and accumulate into it.

    Hardware mode (``seed`` = two uint32 words) renders
    ``settings.samples_per_step`` samples; host-noise mode (``noise`` of
    shape (S, 4 + 4L, P), ``seed`` None) renders S, and the noise carries
    whatever sampler its maker chose (``step_noise(..., qmc_ctx=)``).
    ``cfg.sampler == "sobol"`` draws the Sobol prefix in hardware mode, at
    base ``work.sample_count`` or ``sobol_base`` when given.  Accumulation
    is the reference's: rgb sums, sampleCount += samples, pathLength sums.

    ``sample_axis_index`` is this replica's position j on a mesh's sample
    axis (parallel/mesh.py): the Sobol base moves on by j x
    samples_per_step, so the replicas draw disjoint slices of each lane's
    sequence.  Philox replicas are decorrelated by their seeds instead.
    """
    from ..ops.megastep import render_megastep
    from ..ops.nif import nif_env_shade
    from ..ops.trace import trace_sample

    _check_ported(cfg)
    if (seed is None) == (noise is None):
        raise ValueError("pass exactly one of seed or noise=")
    cols = work.u.to(torch.float32)
    rows = work.v.to(torch.float32)
    n = cols.shape[0]
    samples = settings.samples_per_step if noise is None else noise.shape[0]
    kw = dict(width=cfg.width, height=cfg.height, max_path_length=cfg.max_path_length,
              aa_noise_type=cfg.aa_noise_type)
    if noise is None:
        ctx = make_qmc_ctx(work, cfg, settings, sobol_base)
        if ctx is not None and sample_axis_index:
            ctx = ctx._replace(base=ctx.base + sample_axis_index * settings.samples_per_step)
        kw.update(_kernel_sobol(cfg, ctx))
    if cfg.use_fused_step and isinstance(env, NifEnv):
        out = render_megastep(scene, settings, env.model, cols, rows, seed, noise=noise,
                              stub=cfg.megastep_stub or None, **kw)
        rad, plen = out.radiance, out.path_len
    else:
        rad = Vec3.zeros((n,), device=cols.device)
        plen = torch.zeros(n, dtype=torch.int32, device=cols.device)
        for s in range(samples):
            st = trace_sample(scene, settings, cols, rows, seed,
                              noise=None if noise is None else noise[s], sample_index=s, **kw)
            if isinstance(env, NifEnv):
                contrib = nif_env_shade(env.model, st.esc_dir, st.esc_w, settings.azimuth)
            else:
                u, v = equirect_uv(st.esc_dir, settings.azimuth)
                zero = torch.zeros_like(u)
                u = torch.where(st.escaped, u, zero)
                v = torch.where(st.escaped, v, zero)
                contrib = st.esc_w.cwise(eval_env(env, u, v))
            rad = rad + (st.radiance + contrib)
            plen = plen + st.path_len
    return WorkBatch(
        u=work.u, v=work.v,
        r=work.r + rad.x, g=work.g + rad.y, b=work.b + rad.z,
        sample_count=work.sample_count + samples,
        path_length=work.path_length + plen)
