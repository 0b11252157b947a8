"""The headless progressive render loop.

Counterpart of the headless paths of ``ipu_path_trace_tpu/runtime/app.py``:
build the (coherent) worklist, resolve ``--env-skip``, then per step run
``render_step`` (or ``adaptive_render_step``) on the device.  With the
host film (the default) every step's records are fetched and accumulated
into the host ``Film``; with ``--device-film`` the worklist keeps its
running sums on the device and is fetched only at ``save_interval`` and
at the last step, when the film is rebuilt from it.  PNG + EXR are
written at every ``save_interval`` and at the last step.

Observability, as the reference's: named spans on a ``TraceChannel``
(utils/tracing.py) around each phase, debug-level tensor info of the
scene and the env, ``--device-timing`` (utils/devtime.py) before the
loop, ``--profile-dir`` (a ``torch.profiler`` trace of the render loop,
written as ``trace.json`` in Chrome's format), ``--metrics-file`` (one
JSON line per step and a summary) and, on CUDA, one device-memory line
after the first step.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time

import numpy as np
import torch

from ..core.records import WorkBatch, from_device_batch, to_device_batch
from ..core.scene import default_scene
from ..core.scenefile import load_scene
from ..film.film import Film
from ..film.imageio import load_hdr_image, save_images
from ..models.envlight import ConstantEnv, NifEnv, TextureEnv, bake_nif_env
from ..models.nif import analyse_nif, load_nif_assets
from ..models.quant import quantize_nif
from ..ops.megastep import ENV_SKIP_TILE
from ..render.adaptive import adaptive_render_step
from ..render.params import RenderSettings, StaticConfig
from ..render.wavefront import dead_block_fraction, render_step
from ..utils.devtime import log_phase_split, measure_phases
from ..utils.introspect import log_tensor_info
from ..utils.tracing import TraceChannel
from .config import Config
from .worklist import coherent_order, create_tracing_jobs

log = logging.getLogger(__name__)


def resolve_device(name: str) -> torch.device:
    """The render device; a CUDA request without CUDA raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the port renders on "
                           "the CPU only when asked to (--device cpu)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported --device {name!r} (cuda or cpu)")
    return dev


def parse_env_assets(assets: str, device: torch.device, nif_precision: str = "auto"):
    """Build the environment light from the --assets argument:
    'constant:R,G,B', 'texture:<file.exr>' or a NIF assets dir ->
    (env, (meta, weights) or None).

    ``nif_precision='int8'`` quantises the NIF for the int8 chain
    (models/quant.py): a QAT asset's ``quant_amax.json`` sidecar gives the
    activation grids its fine-tune trained against; without one they are
    calibrated on a (u, v) lattice at load.
    """
    if assets.startswith("constant:"):
        rgb = [float(x) for x in assets.split(":", 1)[1].split(",")]
        if len(rgb) != 3:
            raise ValueError("constant env expects 'constant:R,G,B'")
        return ConstantEnv(colour=tuple(rgb)), None
    if assets.startswith("texture:"):
        img = load_hdr_image(assets.split(":", 1)[1])
        return TextureEnv(texture=torch.from_numpy(img).to(device)), None
    model, meta, weights = load_nif_assets(assets, torch.bfloat16, device)
    if nif_precision == "int8":
        amax = None
        sidecar = os.path.join(assets, "quant_amax.json")
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                amax = [float(a) for a in json.load(f)["amax"]]
            log.info("int8 NIF: using QAT activation grids from %s", sidecar)
        else:
            log.info("int8 NIF: no quant_amax.json sidecar - lattice-calibrating (PTQ)")
        model = quantize_nif(weights, meta, amax=amax, device=device)
    return NifEnv(model=model), (meta, weights)


class PathTracerApp:
    # Auto --env-skip: turn the skip on when at least this fraction of the
    # megastep's NIF sub-tiles have no escape, measured over this many
    # samples (the reference's breakeven rule and threshold).
    AUTO_ENV_SKIP_THRESHOLD = 0.02
    AUTO_ENV_SKIP_PROBE_SAMPLES = 2

    def __init__(self, config: Config):
        self.cfg = config
        self.device = resolve_device(config.device)
        if config.scene:
            self.scene = load_scene(config.scene, self.device)
            log.info("Loaded scene '%s': %d spheres, %d discs", config.scene,
                     self.scene.num_spheres, self.scene.num_discs)
        else:
            self.scene = default_scene(self.device)
        self.env = None
        self.film: Film | None = None
        self.worklist: np.ndarray | None = None
        self.total_spp = 0
        self.env_skip = config.env_skip == "on"
        self.trace = TraceChannel("tpu_path_tracer")

    def init(self) -> None:
        cfg = self.cfg
        self.total_spp = cfg.rounded_samples_per_pixel()
        if self.total_spp != cfg.samples:
            log.info("Rounding SPP to next multiple of %d  (Rounded SPP := %d)",
                     cfg.samples_per_step, self.total_spp)
        self.env, nif_info = parse_env_assets(cfg.assets, self.device, cfg.nif_precision)
        if nif_info is not None:
            meta, weights = nif_info
            info = analyse_nif(weights, cfg.width * cfg.height)
            log.info("NIF layers: %d, hidden size: %d, FLOPs per sample: %d, "
                     "parameters: %.1f KiB", info["layers"], info["hidden_size"],
                     info["flops"], info["parameters_kib"])
            if cfg.nif_mode == "baked":
                h, w = meta.image_shape[:2] if len(meta.image_shape) >= 2 else (2048, 4096)
                t0 = time.monotonic()
                with self.trace.span("bake_nif_env"):
                    self.env = bake_nif_env(self.env, int(h), int(w),
                                            max_batch_size=cfg.max_nif_batch_size)
                    self._sync()
                log.info("Baked NIF env to %dx%d texture in %.3f seconds (--nif-mode baked)",
                         int(h), int(w), time.monotonic() - t0)

    def build(self) -> None:
        cfg = self.cfg
        with self.trace.span("create_path_tracing_jobs"):
            worklist = create_tracing_jobs(cfg.width, cfg.height)
            if cfg.layout == "coherent":
                worklist = coherent_order(worklist, self.scene, cfg.width, cfg.height, cfg.fov)
        self.worklist = worklist
        self.film = Film(cfg.width, cfg.height)
        if cfg.adaptive and not isinstance(self.env, NifEnv):
            raise ValueError("--adaptive requires a NIF environment (--assets <dir>); the "
                             "budget controller lives in the fused megastep")
        log_tensor_info("scene", self.scene)
        log_tensor_info("env", self.env)
        with self.trace.span("resolve_env_skip"):
            self.env_skip = self.resolve_env_skip()

    def resolve_env_skip(self) -> bool:
        """--env-skip as the megastep's flag.  "auto" traces
        AUTO_ENV_SKIP_PROBE_SAMPLES Philox samples over the real ordered
        worklist (K1 on CUDA, its plain version on the CPU), measures the
        fraction of NIF tiles with no escape - the skip guard's own
        criterion, at the tile of the model's chain (the 128-ray wgmma
        tile of both chains) - and turns the skip on at
        AUTO_ENV_SKIP_THRESHOLD.  No
        probe runs when the fused NIF megastep, the only kernel with the
        skip, will not."""
        cfg = self.cfg
        if cfg.env_skip != "auto":
            return cfg.env_skip == "on"
        if not (cfg.use_fused_step and isinstance(self.env, NifEnv)):
            return False
        cols = torch.from_numpy(self.worklist["u"].astype(np.float32)).to(self.device)
        rows = torch.from_numpy(self.worklist["v"].astype(np.float32)).to(self.device)
        tile = ENV_SKIP_TILE  # the skip's tile in the kernel of either chain
        t0 = time.monotonic()
        frac = dead_block_fraction(self.scene, self.settings(), self.static_config(), cols, rows,
                                   step_seed(torch.Generator().manual_seed(cfg.seed)),
                                   self.AUTO_ENV_SKIP_PROBE_SAMPLES, tile)
        skip = frac >= self.AUTO_ENV_SKIP_THRESHOLD
        log.info("--env-skip auto: dead-block fraction %.4f at block %d (threshold %.3f, "
                 "probe %.1fs) -> %s", frac, tile, self.AUTO_ENV_SKIP_THRESHOLD,
                 time.monotonic() - t0, "on" if skip else "off")
        return skip

    def settings(self) -> RenderSettings:
        cfg = self.cfg
        return RenderSettings.make(
            fov_degrees=cfg.fov, aa_scale=cfg.aa_noise_scale,
            env_rotation_degrees=cfg.env_map_rotation,
            refractive_index=cfg.refractive_index, stop_prob=cfg.stop_prob,
            roulette_depth=cfg.roulette_depth, samples_per_step=cfg.samples_per_step,
            aperture=cfg.aperture, focal_distance=cfg.focal_distance, seed=cfg.seed)

    def static_config(self) -> StaticConfig:
        cfg = self.cfg
        return StaticConfig(width=cfg.width, height=cfg.height,
                            max_path_length=cfg.max_path_length,
                            aa_noise_type=cfg.aa_noise_type,
                            use_fused_step=cfg.use_fused_step,
                            adaptive_min=cfg.adaptive_min,
                            adaptive_max_factor=cfg.adaptive_max_factor,
                            env_skip=self.env_skip, sampler=cfg.sampler,
                            sobol_dims=cfg.sobol_dims)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def execute(self) -> Film:
        """Render ``total_spp / samples_per_step`` steps into the film."""
        cfg = self.cfg
        steps = self.total_spp // cfg.samples_per_step
        gen = torch.Generator().manual_seed(cfg.seed)  # per-step kernel seed words
        if cfg.device_timing:
            self._device_timing()
        start = time.monotonic()
        log.info("Render started on %s (%s film)", self.device,
                 "device" if cfg.device_film else "host")
        run = self._device_film_steps if cfg.device_film else self._host_film_steps
        with self._profiler() if cfg.profile_dir else contextlib.nullcontext() as prof:
            run(steps, gen)
        elapsed = time.monotonic() - start
        if prof is not None:
            self._write_profile(prof)
        rate = cfg.width * cfg.height * self.total_spp / elapsed
        log.info("Render finished: %.3f seconds (Samples/sec: %.4g)", elapsed, rate)
        self._emit_metrics({"event": "summary", "elapsed_seconds": round(elapsed, 3),
                            "total_spp": int(self.total_spp),
                            "samples_per_sec": round(rate, 1), "chips": 1})
        return self.film

    def _device_timing(self) -> None:
        """--device-timing: the per-sample phase split at the render's
        shapes, before the loop (utils/devtime.py), on the first step's
        seed words; the render's own stream is untouched."""
        if self.cfg.adaptive:
            log.warning("--device-timing with --adaptive reports the uniform step's phase "
                        "split (the adaptive schedule shifts samples between blocks)")
        seed = step_seed(torch.Generator().manual_seed(self.cfg.seed))
        with self.trace.span("device_timing"):
            split = measure_phases(self.scene, self.settings(), self.static_config(),
                                   to_device_batch(self.worklist, self.device), seed, self.env)
        log_phase_split(split)

    def _profiler(self) -> torch.profiler.profile:
        """--profile-dir: the render loop under torch.profiler, the card's
        kernels included on CUDA."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        log.info("Profiler trace -> '%s'", self.cfg.profile_dir)
        return torch.profiler.profile(activities=acts)

    def _write_profile(self, prof: torch.profiler.profile) -> None:
        path = os.path.join(self.cfg.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        if log.isEnabledFor(logging.DEBUG):
            sort = "self_cuda_time_total" if self.device.type == "cuda" else "self_cpu_time_total"
            log.debug("Profile of the render loop:\n%s",
                      prof.key_averages().table(sort_by=sort, row_limit=25))
        log.info("Profiler trace written to %s", path)

    def _emit_metrics(self, record: dict) -> None:
        """Append one JSON line to --metrics-file."""
        if self.cfg.metrics_file:
            with open(self.cfg.metrics_file, "a") as f:
                f.write(json.dumps(record) + "\n")

    def _log_device_memory(self) -> None:
        """One-shot device-memory line after the first step (CUDA only)."""
        if self.device.type != "cuda":
            return
        free, total = torch.cuda.mem_get_info(self.device)
        mib = 2.0**20
        log.info("Device memory after first step: %.0f MiB in use, peak %.0f MiB, "
                 "limit %.0f MiB (%.0f MiB free)", torch.cuda.memory_allocated(self.device) / mib,
                 torch.cuda.max_memory_allocated(self.device) / mib, total / mib, free / mib)

    def _after_step(self, step: int, steps: int, secs: float, **extra) -> None:
        cfg = self.cfg
        rate = cfg.width * cfg.height * cfg.samples_per_step / secs
        self._emit_metrics({"step": step, "steps": steps, "seconds": round(secs, 4),
                            "samples_per_sec": round(rate, 1), **extra,
                            "spp_per_step": cfg.samples_per_step})
        if step == 1:
            self._log_device_memory()

    def _save(self, step: int, norm: int, since: float) -> None:
        cfg = self.cfg
        with self.trace.span("save_images"):
            save_images(cfg.outfile, self.film.hdr_at_step(norm),
                        self.film.ldr(norm, cfg.exposure, cfg.gamma))
        log.info("Saved images at step %d in %.3f seconds", step, time.monotonic() - since)

    def _host_film_steps(self, steps: int, gen: torch.Generator) -> None:
        """Each step renders into zeroed accumulators and the host film
        adds its records (the reference's host pipeline)."""
        cfg = self.cfg
        settings, static = self.settings(), self.static_config()
        work = to_device_batch(self.worklist, self.device)
        for step in range(1, steps + 1):
            t0 = time.monotonic()
            with self.trace.span("ipu_render"):
                # The counts restart at 0 every step, so the Sobol sampler
                # is told how many samples each lane already has.
                out = render_step(self.scene, settings, static, work, step_seed(gen), self.env,
                                  sobol_base=(step - 1) * cfg.samples_per_step)
                records = from_device_batch(out)  # the fetch waits for the device
            t1 = time.monotonic()
            with self.trace.span("accumulate_framebuffers"):
                self.film.accumulate(records)
            t2 = time.monotonic()
            rate = cfg.width * cfg.height * cfg.samples_per_step / (t2 - t0)
            log.info("Completed render step %d/%d in %.3f seconds (render+fetch %.3f, "
                     "film %.3f; Samples/sec %.3g)", step, steps, t2 - t0, t1 - t0,
                     t2 - t1, rate)
            rays = int(records["pathLength"].sum(dtype=np.int64))
            self._after_step(step, steps, t2 - t0, rays_per_sec=round(rays / (t2 - t0), 1))
            if step % cfg.save_interval == 0 or step == steps:
                self._save(step, step, t2)

    def _device_film_steps(self, steps: int, gen: torch.Generator) -> None:
        """The worklist (and, adaptive, the second moments) stay on the
        device; a fetch rebuilds the film from the running sums, whose
        rgb / sampleCount is each pixel's mean, so the film saves at
        normalisation 1."""
        cfg = self.cfg
        settings, static = self.settings(), self.static_config()
        work = to_device_batch(self.worklist, self.device)
        lum2 = (torch.zeros(work.u.shape[0], dtype=torch.float32, device=self.device)
                if cfg.adaptive else None)
        for step in range(1, steps + 1):
            t0 = time.monotonic()
            with self.trace.span("ipu_render"):
                if cfg.adaptive:
                    work, lum2 = adaptive_render_step(self.scene, settings, static, work, lum2,
                                                      step_seed(gen), self.env)
                else:
                    work = render_step(self.scene, settings, static, work, step_seed(gen),
                                       self.env)
                self._sync()  # the step's seconds are the device's, not the enqueue's
            t1 = time.monotonic()
            save = step % cfg.save_interval == 0 or step == steps
            if save:  # int32 counts: no u16 wire record on this path
                with self.trace.span("accumulate_framebuffers"):
                    host = WorkBatch(*(t.cpu().numpy() for t in work))
                    self.film.reset()
                    self.film.accumulate_soa(host.u, host.v, host.r, host.g, host.b,
                                             host.sample_count)
            t2 = time.monotonic()
            rate = cfg.width * cfg.height * cfg.samples_per_step / (t2 - t0)
            log.info("Completed render step %d/%d in %.3f seconds (render %.3f, fetch+film "
                     "%.3f; Samples/sec %.3g)", step, steps, t2 - t0, t1 - t0, t2 - t1, rate)
            self._after_step(step, steps, t2 - t0)
            if save:
                self._save(step, 1, t2)


def step_seed(gen: torch.Generator) -> tuple[int, int]:
    """The next two uint32 seed words of the kernels' Philox stream."""
    return tuple(int(x) for x in torch.randint(0, 1 << 32, (2,), generator=gen))
