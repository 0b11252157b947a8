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
name.

On a mesh (parallel/mesh.py) the sharded step is timed - on one card
with CUDA events, across distinct GPUs with the host clock between syncs
of them all - and the rate is also reported per chip
(``mpaths_per_sec_chip``); the fused split runs the stubs through the
sharded step, and the unfused standalone split is skipped, as the
reference skips it.
"""

from __future__ import annotations

import shutil
import subprocess
import time

import torch

from ..models.envlight import NifEnv
from .logging import logger

DEVICE_LOOP = 300  # samples per timed launch on the card: the canonical step


def time_per_call(fn, reps: int, device: torch.device, mesh=None) -> float:
    """Seconds per call after one warm-up: CUDA events on the card, the
    host clock for the plain versions on the CPU and for a mesh over
    distinct GPUs (synchronised before and after)."""
    fn()
    if mesh is not None and len(mesh.distinct()) > 1:
        mesh.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        mesh.synchronize()
        return (time.perf_counter() - t0) / reps
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


def card_line(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card (its name alone when
    nvidia-smi is missing): every time a probe prints goes beside it."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return torch.cuda.get_device_name(device)
    return subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu, plain versions"


def measure_phases(scene, settings, cfg, work, seed, env, loop: int | None = None,
                   reps: int = 2, mesh=None) -> dict:
    """Per-sample time of each phase at the given shapes (ms).

    Returns ``step_ms``, ``mpaths_per_sec`` and ``device`` (and on a mesh
    ``mpaths_per_sec_chip``); for the fused NIF path also ``env_ms``, ``trace_ms``,
    ``overhead_ms`` (which sum to ``step_ms``); for the unfused path off a
    mesh ``trace_ms`` and, with a NIF env, ``env_ms`` of the standalone
    kernels.  ``loop`` defaults to DEVICE_LOOP samples per launch on CUDA,
    where one megastep launch renders them all, and to
    ``settings.samples_per_step`` on the CPU, whose plain versions have no
    launch cost to amortise.  With ``mesh`` the step is the sharded one
    (``scene`` and ``env`` replicated or plain, ``work`` the whole
    worklist): a step renders ``loop`` samples on each sample replica."""
    from ..ops.nif import nif_env_shade
    from ..ops.trace import trace_sample
    from ..parallel.mesh import make_step_fn, replicate, shard_work

    device = work.u.device if mesh is None else mesh.first
    if loop is None:
        loop = DEVICE_LOOP if device.type == "cuda" else settings.samples_per_step
    n_pixels = int(work.u.shape[0])
    loop_settings = settings._replace(samples_per_step=loop)
    replicas, chips = (1, 1) if mesh is None else (mesh.shape["samples"], mesh.size)
    if mesh is not None:
        scene, env, work = replicate(scene, mesh), replicate(env, mesh), shard_work(work, mesh)

    def per_sample(c) -> float:
        step = make_step_fn(c, mesh)
        return time_per_call(lambda: step(scene, loop_settings, work, seed, env),
                             reps, device, mesh) / loop

    step_s = per_sample(cfg)
    rate = n_pixels * replicas / step_s / 1e6
    out = {"device": device_label(device), "step_ms": step_s * 1e3, "mpaths_per_sec": rate}
    if mesh is not None:
        out["mpaths_per_sec_chip"] = rate / chips
    nif_env = isinstance(env.on(device) if mesh is not None else env, NifEnv)
    if cfg.use_fused_step and nif_env:
        nif_stub_s = per_sample(cfg._replace(megastep_stub="nif"))
        skeleton_s = per_sample(cfg._replace(megastep_stub="both"))
        out["env_ms"] = max(step_s - nif_stub_s, 0.0) * 1e3
        out["trace_ms"] = max(nif_stub_s - skeleton_s, 0.0) * 1e3
        out["overhead_ms"] = skeleton_s * 1e3
        return out
    if mesh is not None:
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
    if split.get("mpaths_per_sec_chip", split["mpaths_per_sec"]) != split["mpaths_per_sec"]:
        parts[-1] = f"({split['mpaths_per_sec']:.1f} Mpaths/s, " \
                    f"{split['mpaths_per_sec_chip']:.1f} Mpaths/s/chip)"
    for key, name in (("trace_ms", "trace"), ("env_ms", "nif-env"),
                      ("overhead_ms", "other")):
        if key in split:
            parts.append(f"{name}={split[key]:.3f}ms")
    logger().info("Device phase timing [%s]: %s", split["device"], " ".join(parts))
