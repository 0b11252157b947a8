"""Per-phase device timing (--device-timing), the cycle-counter analog.

Counterpart of ``ipu_path_trace_tpu/utils/devtime.py``.  The reference
wraps its trace, its NIF and its whole iteration in device cycle counters;
here the split comes from the kernel that renders, run in three variants
(``StaticConfig.megastep_stub``, csrc/megastep.cuh):

  step_ms  = the production step (render_step, the full K3)
  nif-stub = the same kernel with the NIF chain's products stubbed
  skeleton = the same kernel with the chain and the bounce both stubbed

  env_ms = step - nif-stub;  trace_ms = nif-stub - skeleton;
  overhead_ms = skeleton

The unfused path times its standalone kernels instead: K1, and K2 when
the env is a NIF.

On CUDA every variant runs ``loop`` samples in one launch between CUDA
events, after a warm-up, ``reps`` times; times are per full-frame sample.
On the CPU (``--device cpu``) the plain versions are timed with the host
clock, and the result says so: no CPU number is reported under a device's
name.  The reference's mesh branch is not ported (ROADMAP queue 1 item
15).
"""

from __future__ import annotations

import time

import torch

from ..models.envlight import NifEnv
from .logging import logger

DEVICE_LOOP = 300  # samples per timed launch on the card: the canonical step


def time_per_call(fn, reps: int, device: torch.device) -> float:
    """Seconds per call after one warm-up: CUDA events on the card, the
    host clock for the plain versions on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / reps


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu, plain versions"


def measure_phases(scene, settings, cfg, work, seed, env, loop: int | None = None,
                   reps: int = 2) -> dict:
    """Per-sample time of each phase at the given shapes (ms).

    Returns ``step_ms``, ``mpaths_per_sec`` and ``device``; for the fused
    NIF path also ``env_ms``, ``trace_ms``, ``overhead_ms`` (which sum to
    ``step_ms``); for the unfused path ``trace_ms``
    and, with a NIF env, ``env_ms`` of the standalone kernels.  ``loop``
    defaults to DEVICE_LOOP samples per launch on CUDA, where one megastep
    launch renders them all, and to ``settings.samples_per_step`` on the
    CPU, whose plain versions have no launch cost to amortise."""
    from ..ops.nif import nif_env_shade
    from ..ops.trace import trace_sample
    from ..render.wavefront import render_step

    device = work.u.device
    if loop is None:
        loop = DEVICE_LOOP if device.type == "cuda" else settings.samples_per_step
    n_pixels = int(work.u.shape[0])
    loop_settings = settings._replace(samples_per_step=loop)

    def per_sample(c) -> float:
        return time_per_call(lambda: render_step(scene, loop_settings, c, work, seed, env),
                     reps, device) / loop

    step_s = per_sample(cfg)
    out = {"device": device_label(device), "step_ms": step_s * 1e3,
           "mpaths_per_sec": n_pixels / step_s / 1e6}
    if cfg.use_fused_step and isinstance(env, NifEnv):
        nif_stub_s = per_sample(cfg._replace(megastep_stub="nif"))
        skeleton_s = per_sample(cfg._replace(megastep_stub="both"))
        out["env_ms"] = max(step_s - nif_stub_s, 0.0) * 1e3
        out["trace_ms"] = max(nif_stub_s - skeleton_s, 0.0) * 1e3
        out["overhead_ms"] = skeleton_s * 1e3
        return out
    cols, rows = work.u.to(torch.float32), work.v.to(torch.float32)
    kw = dict(width=cfg.width, height=cfg.height, max_path_length=cfg.max_path_length,
              aa_noise_type=cfg.aa_noise_type)

    def trace_loop():
        for i in range(loop):
            trace_sample(scene, settings, cols, rows, seed, sample_index=i, **kw)

    out["trace_ms"] = time_per_call(trace_loop, reps, device) / loop * 1e3
    if isinstance(env, NifEnv):
        st = trace_sample(scene, settings, cols, rows, seed, **kw)

        def env_loop():
            for i in range(loop):
                nif_env_shade(env.model, st.esc_dir, st.esc_w, settings.azimuth + 1e-6 * i)

        out["env_ms"] = time_per_call(env_loop, reps, device) / loop * 1e3
    return out


def log_phase_split(split: dict) -> None:
    """Log the measured split (the per-step cycle-count analog)."""
    parts = [f"step={split['step_ms']:.3f}ms/sample",
             f"({split['mpaths_per_sec']:.1f} Mpaths/s)"]
    for key, name in (("trace_ms", "trace"), ("env_ms", "nif-env"),
                      ("overhead_ms", "other")):
        if key in split:
            parts.append(f"{name}={split[key]:.3f}ms")
    logger().info("Device phase timing [%s]: %s", split["device"], " ".join(parts))
