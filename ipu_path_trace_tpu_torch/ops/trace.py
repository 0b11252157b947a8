"""K1: the trace kernel - one sample per pixel through the bounce loop.

Replaces ``ipu_path_trace_tpu/ops/trace_pallas.py::trace_sample_pallas``.
``trace_sample`` launches ``csrc/trace.cu`` for CUDA tensors; for CPU
tensors it runs ``trace_sample_plain``, the plain PyTorch version
(render/wavefront.trace_sample_with_uniforms, the port of the
reference's XLA twin).

Three noise modes, as the reference kernel: ``noise`` (host noise, the
(4 + 4L, P) row layout of render/wavefront.sample_noise), ``seed`` (two
uint32 words keying the in-kernel Philox4x32-10 stream; see
csrc/common.cuh), and ``seed`` with ``sobol=(pixel_id, base, key)``: the
first ``sobol_dims`` rows from each lane's Owen-scrambled Sobol sequence
at index base + sample_index (render/qmc.py), the rest from Philox.
``philox_noise`` replays the Philox stream on the host in the host-noise
layout, and render/wavefront.sobol_prefix writes the Sobol rows over it:
that is how the plain version serves the hardware modes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..core.scene import Scene
from ..core.vecmath import Vec3
from . import _lib

_AA_TYPES = {"uniform": 0, "normal": 1, "truncated-normal": 2}
_MASK32 = 0xFFFFFFFF


class TraceOut(NamedTuple):
    radiance: Vec3
    esc_dir: Vec3
    esc_w: Vec3
    escaped: torch.Tensor  # bool
    path_len: torch.Tensor  # int32


# pack_scene's cache: (device, the scene's tensors' keys) -> (scene, tables).
_TABLES: dict = {}
_TABLES_MAX = 8


def pack_scene(scene: Scene, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 tables on ``device`` (default: the scene's): 12 floats per
    sphere (cx cy cz r | rgb colour | rgb emission | emissive material), 15
    per disc (nx ny nz cx cy cz r | ...), and a 1-float dummy for an empty
    class, never read: the kernel loops over the counts.

    Cached per scene and device (``_TABLES``), so a repeated launch copies
    nothing to the card and launches no kernel for them.  A scene is known
    by its tensors' devices, data pointers, versions, shapes and types; an
    entry holds the scene, so no other scene's tensors can take over its
    pointers while it lives, and an in-place edit bumps a version."""
    dev = scene.sphere_center.device if device is None else torch.device(device)
    key = (dev, tuple((t.device, t.data_ptr(), t._version, tuple(t.shape), t.dtype)
                      for t in scene))
    hit = _TABLES.get(key)
    if hit is None:
        if len(_TABLES) >= _TABLES_MAX:
            _TABLES.pop(next(iter(_TABLES)))
        hit = _TABLES[key] = (scene, _pack(scene.to(dev)))
    return hit[1]


def _pack(scene: Scene) -> tuple[torch.Tensor, torch.Tensor]:
    ns, nd = scene.num_spheres, scene.num_discs
    f = torch.float32
    sph = torch.cat([
        scene.sphere_center, scene.sphere_radius[:, None], scene.colour[:ns],
        scene.emission[:ns], scene.emissive[:ns, None].to(f),
        scene.material[:ns, None].to(f)], dim=1).reshape(-1)
    dsc = torch.cat([
        scene.disc_normal, scene.disc_center, scene.disc_radius[:, None],
        scene.colour[ns:], scene.emission[ns:], scene.emissive[ns:, None].to(f),
        scene.material[ns:, None].to(f)], dim=1).reshape(-1)
    dummy = torch.zeros(1, dtype=f, device=sph.device)
    return (sph.contiguous() if ns else dummy), (dsc.contiguous() if nd else dummy)


def tan_fov(fov: float, width: int, height: int, device) -> tuple[float, float]:
    """f32 tan(fov/2) and tan((h/w) fov/2), computed on ``device`` exactly
    as pixel_to_ray computes them there: once per (fov, width, height,
    device), then read from the cache (``_tan_fov``), so a repeated launch
    waits for no read-back from the card."""
    return _tan_fov(float(fov), int(width), int(height), torch.device(device))


@functools.lru_cache(maxsize=64)
def _tan_fov(fov: float, width: int, height: int, device: torch.device) -> tuple[float, float]:
    half = torch.tensor(fov, dtype=torch.float32, device=device) * 0.5
    ratio = (torch.tensor(float(height), device=device)
             / torch.tensor(float(width), device=device))
    return float(torch.tan(half)), float(torch.tan(ratio * half))


def trace_params(scene: Scene, settings, *, width: int, height: int,
                 max_path_length: int, aa_noise_type: str,
                 seed: tuple[int, int] | None, device, sobol=None,
                 sobol_dims: int = 0) -> _lib.TraceParams:
    if aa_noise_type not in _AA_TYPES:
        raise ValueError(f"Invalid AA noise type: {aa_noise_type!r}")
    tx, ty = tan_fov(settings.fov, width, height, device)
    s0, s1 = (0, 0) if seed is None else (int(seed[0]) & _MASK32, int(seed[1]) & _MASK32)
    return _lib.TraceParams(
        tanfov_x=tx, tanfov_y=ty, aa_scale=settings.aa_scale,
        refr_index=settings.refractive_index, stop_prob=settings.stop_prob,
        aperture=settings.aperture, focal=settings.focal_distance,
        azimuth=settings.azimuth, width=width, height=height,
        max_path_length=max_path_length, roulette_depth=settings.roulette_depth,
        aa_type=_AA_TYPES[aa_noise_type], num_s=scene.num_spheres,
        num_d=scene.num_discs, sobol_dims=sobol_dims if sobol is not None else 0,
        seed0=s0, seed1=s1, sobol_key=0 if sobol is None else int(sobol[2]) & _MASK32, pad0=0)


def check_mode(seed, noise, sobol, sobol_dims: int, max_path_length: int, n: int) -> None:
    """Exactly one of ``seed`` and ``noise``, and check_sobol's rules."""
    if (seed is None) == (noise is None):
        raise ValueError("pass exactly one of seed= or noise=")
    check_sobol(sobol, sobol_dims, max_path_length, seed, n)


def check_sobol(sobol, sobol_dims: int, max_path_length: int, seed, n: int) -> None:
    """The Sobol mode's operands: (pixel_id, base, key) with (P,) int32
    ids and bases, hardware mode (a seed for the Philox tail), and a
    prefix of whole groups within the noise layout."""
    if sobol is None:
        if sobol_dims:
            raise ValueError("sobol_dims needs sobol=(pixel_id, base, key)")
        return
    if seed is None:
        raise ValueError("sobol mode is hardware mode (host noise carries its own Sobol rows)")
    if sobol_dims < 4 or sobol_dims % 4 or sobol_dims > 4 + 4 * max_path_length:
        raise ValueError(f"sobol_dims {sobol_dims} must be a multiple of 4 in [4, 4 + 4L]")
    for t in sobol[:2]:
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError("sobol pixel_id/base must be (P,) int32")


# ---------------------------------------------------------------- Philox ----

def _mulhilo32(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the 64-bit product of the constant ``a`` and the
    uint32 values in int64 ``b``, without int64 overflow."""
    hp = a * (b >> 16)  # < 2^48
    lp = a * (b & 0xFFFF)
    s = lp + ((hp & 0xFFFF) << 16)  # < 2^49
    return (hp >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c: list[torch.Tensor], k0: int, k1: int) -> list[torch.Tensor]:
    """Philox4x32-10 on int64 tensors holding uint32 words (the counter
    words broadcast); the same rounds as csrc/common.cuh::philox4x32_10."""
    x0, x1, x2, x3 = c
    for _ in range(10):
        hi0, lo0 = _mulhilo32(0xD2511F53, x0)
        hi1, lo1 = _mulhilo32(0xCD9E8D57, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return [x0, x1, x2, x3]


def _u24(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 8) + 1).to(torch.float32) * (1.0 / (1 << 24))


def draw_aa_jitter(u1: torch.Tensor, u2: torch.Tensor, aa_noise_type: str):
    """AA jitter pair from two uniforms: uniform, normal (Box-Muller) or
    truncated-normal clipped at +/- 3 sigma."""
    if aa_noise_type == "uniform":
        return 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    two_pi = 2.0 * math.pi
    r = torch.sqrt(-2.0 * torch.log(u1))
    z1 = r * torch.cos(two_pi * u2)
    z2 = r * torch.sin(two_pi * u2)
    if aa_noise_type == "truncated-normal":
        z1, z2 = torch.clamp(z1, -3.0, 3.0), torch.clamp(z2, -3.0, 3.0)
    return z1, z2


def philox_noise(seed: tuple[int, int], sample_index: int, n: int,
                 max_path_length: int, aa_noise_type: str, device) -> torch.Tensor:
    """The hardware-mode stream of one sample in the host-noise layout
    (4 + 4L, n): group g of lane p is Philox((p, sample, g, 0), seed)."""
    lane = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(lane)
    k0, k1 = int(seed[0]) & _MASK32, int(seed[1]) & _MASK32
    rows = []
    for g in range(1 + max_path_length):
        words = philox4x32_10([lane, zero + (sample_index & _MASK32), zero + g, zero], k0, k1)
        rows.extend(_u24(w) for w in words)
    rows[0], rows[1] = draw_aa_jitter(rows[0], rows[1], aa_noise_type)
    return torch.stack(rows)


def sample_rows(seed, noise, sample_index: int, n: int, max_path_length: int,
                aa_noise_type: str, device, sobol=None, sobol_dims: int = 0) -> torch.Tensor:
    """The (4 + 4L, n) noise rows a kernel reads for one sample: ``noise``
    itself (host noise), else the Philox stream's sample, with the Sobol
    prefix in Sobol mode."""
    from ..render.wavefront import QmcCtx, sobol_prefix

    if noise is not None:
        return noise
    rows = philox_noise(seed, sample_index, n, max_path_length, aa_noise_type, device)
    if sobol is not None:
        rows = sobol_prefix(rows, QmcCtx(*sobol), sample_index, sobol_dims, aa_noise_type)
    return rows


# ---------------------------------------------------------------- K1 ----

def trace_sample_plain(scene: Scene, settings, cols, rows, seed=None, *,
                       noise=None, sample_index: int = 0, width: int, height: int,
                       max_path_length: int, aa_noise_type: str = "normal", sobol=None,
                       sobol_dims: int = 0) -> TraceOut:
    """Plain PyTorch version of the trace kernel."""
    from ..render.params import StaticConfig
    from ..render.wavefront import trace_sample_with_uniforms

    if cols.is_cuda:
        trace_sample_plain.cuda_runs += 1
    n = cols.shape[0]
    noise = sample_rows(seed, noise, sample_index, n, max_path_length, aa_noise_type,
                        cols.device, sobol, sobol_dims)
    cfg = StaticConfig(width=width, height=height, max_path_length=max_path_length,
                       aa_noise_type=aa_noise_type)
    st = trace_sample_with_uniforms(scene, settings, cfg, cols, rows, noise[0:2],
                                    noise[2:4], noise[4:].reshape(max_path_length, 4, n))
    return TraceOut(st.radiance, st.esc_dir, st.esc_w, st.escaped, st.path_len)


trace_sample_plain.cuda_runs = 0


class TraceLaunch:
    """One K1 launch with its operands prepared (``prepare_trace``):
    ``launch()`` runs the kernel into the outputs, ``out()`` returns them.
    trace_sample prepares one per call; timing the kernel alone launches one
    back to back."""

    def __init__(self, args: tuple, outputs: tuple, keep: tuple, device: torch.device):
        # keep: the tensors and structs behind the pointers in args.
        self.args, self._outputs, self._keep, self.device = args, outputs, keep, device

    def launch(self) -> None:
        with torch.cuda.device(self.device):  # the launch's SM count and stream
            _lib.check(_lib.library().pt_trace(*self.args), "trace")
        trace_sample.launches += 1

    def out(self) -> TraceOut:
        rad, escd, escw, escm, plen = self._outputs
        return TraceOut(Vec3.unstack(rad), Vec3.unstack(escd), Vec3.unstack(escw),
                        escm != 0, plen)


def prepare_trace(scene: Scene, settings, cols, rows, seed=None, *, noise=None,
                  sample_index: int = 0, width: int, height: int, max_path_length: int,
                  aa_noise_type: str = "normal", sobol=None,
                  sobol_dims: int = 0) -> TraceLaunch:
    """K1's operands for CUDA tensors (trace_sample's arguments): checked,
    the launch parameters and the scene's tables from their caches (no
    device round trip on a repeated launch), the outputs allocated."""
    n = cols.shape[0]
    check_mode(seed, noise, sobol, sobol_dims, max_path_length, n)
    operands = [cols, rows] + ([] if noise is None else [noise]) + (
        [] if sobol is None else list(sobol[:2]))
    dev = _lib.require_cuda("trace", *operands)
    if cols.dtype != torch.float32 or rows.dtype != torch.float32 or rows.shape != (n,):
        raise ValueError("trace: cols/rows must be (P,) float32")
    if noise is not None and (noise.dtype != torch.float32
                              or noise.shape != (4 + 4 * max_path_length, n)):
        raise ValueError(f"trace: noise must be ({4 + 4 * max_path_length}, {n}) float32")
    prm = trace_params(scene, settings, seed=seed, device=dev, sobol=sobol,
                       sobol_dims=sobol_dims, width=width, height=height,
                       max_path_length=max_path_length, aa_noise_type=aa_noise_type)
    sph, dsc = pack_scene(scene, dev)
    rad = torch.empty((3, n), dtype=torch.float32, device=dev)
    escd = torch.empty_like(rad)
    escw = torch.empty_like(rad)
    escm = torch.empty(n, dtype=torch.int32, device=dev)
    plen = torch.empty(n, dtype=torch.int32, device=dev)
    next_ray = torch.empty(1, dtype=torch.int32, device=dev)  # the kernel's batch counter
    pid, base = (None, None) if sobol is None else sobol[:2]
    args = (ctypes.byref(prm), _lib.ptr(sph), _lib.ptr(dsc), _lib.ptr(cols), _lib.ptr(rows),
            _lib.ptr(noise), _lib.ptr(pid), _lib.ptr(base), sample_index, n, _lib.ptr(next_ray),
            _lib.ptr(rad), _lib.ptr(escd), _lib.ptr(escw), _lib.ptr(escm), _lib.ptr(plen),
            _lib.stream(dev))
    return TraceLaunch(args, (rad, escd, escw, escm, plen), (prm, sph, dsc, next_ray), dev)


def trace_sample(scene: Scene, settings, cols, rows, seed=None, *, noise=None,
                 sample_index: int = 0, width: int, height: int,
                 max_path_length: int, aa_noise_type: str = "normal", sobol=None,
                 sobol_dims: int = 0) -> TraceOut:
    """Trace one sample per pixel: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    Exactly one of ``seed`` ((2,) uint32 words; hardware mode, sample
    ``sample_index`` of the Philox stream) or ``noise`` ((4 + 4L, P) f32
    host noise).  ``cols``/``rows`` are (P,) f32 pixel coordinates.
    ``sobol=(pixel_id, base, key)`` with ``sobol_dims`` > 0 (hardware
    mode only) draws the first ``sobol_dims`` rows from the Owen-Sobol
    sequence at index base + sample_index.
    """
    kw = dict(noise=noise, sample_index=sample_index, width=width, height=height,
              max_path_length=max_path_length, aa_noise_type=aa_noise_type, sobol=sobol,
              sobol_dims=sobol_dims)
    if cols.device.type == "cpu":
        check_mode(seed, noise, sobol, sobol_dims, max_path_length, cols.shape[0])
        return trace_sample_plain(scene, settings, cols, rows, seed, **kw)
    run = prepare_trace(scene, settings, cols, rows, seed, **kw)
    run.launch()
    return run.out()


trace_sample.launches = 0
