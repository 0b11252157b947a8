"""The progressive render loop, headless or under the remote UI.

Counterpart of ``ipu_path_trace_tpu/runtime/app.py``: build the worklist
(coherent, raster, or the load balancer's shuffle), then per step run
``render_step`` (or ``adaptive_render_step``) on the device while a host task
(runtime/async_task.py) post-processes the step before.

With ``--ipus N`` (N > 1) or a ``--mesh-shape`` the step is sharded over
a device mesh (parallel/mesh.py): the first N GPUs, or N shards on the
CPU with ``--device cpu``.  The scene and the env (a baked one baked on
each device) are replicated, the worklist is padded to a multiple of the
pixel axis and split along it, each sample replica renders
``samples_per_step`` / S samples, and the fetch gathers the shards.  The
film, the checkpoint, the UI and the host task see the whole worklist as
on one device; the summary's rate is also given per chip.

With the host film (the default) each step renders the worklist's active
buffer and fetches its records into it; the main thread then waits for
the host task, swaps the double buffer and hands the inactive buffer to
a new task, which accumulates it into the film (the native host runtime,
runtime/native.py), re-deals it under ``--enable-load-balancing`` from
step 2, clears it (summing its path lengths for Rays/sec, which so lags
one step), and at save steps writes the checkpoint and the images.  With
``--device-film`` the worklist keeps its running sums on the device; at
save steps the main thread fetches it and the task rebuilds the film,
checkpoints and saves.  Every launch and every fetch stays on the main
thread; the task touches host arrays only, and its native calls release
the interpreter lock.

With a remote UI (``execute(ui_server=...)``, ui/server.py) each step
renders ``interactive_samples`` until SAMPLE_COUNT_REVERSION_STEP quiet
steps pass, and sends a tone-mapped preview (with ``--denoise`` the
denoised one) and the progress: the host film's host task tone-maps
the film with the native tone map; the device film's main thread
computes the preview on the card from the running sums
(``_device_preview``, ``_device_preview_denoised``) and fetches only the
H x W x 3 bytes.  Between steps the client's state is applied: exposure
and gamma only change the tone map; fov, env rotation, a NIF hot swap
and a valid ``interactive_samples`` restart the render (film, worklist,
second moments, step counter, Sobol base and step seeds); stop ends the
loop, detach drops the client.  Save steps stream the raw HDR to the
client instead of writing ``-o``; the exit path writes it.

``--denoise`` filters the saved images (and the previews) with the
à-trous denoiser (film/denoise.py) on the app's device, guided by
primary-hit buffers cached per (fov, env rotation, assets); called from
the host task on CUDA it runs on a stream of its own, ordered after the
guides by an event, so it does not queue behind the next render step.
``--debug-view`` saves a diagnostic channel instead (film/debugview.py).

A resume (``--resume``, ``--auto-resume``; runtime/checkpoint.py)
restores the state and replays the step-seed draws of the steps done.
On a stop request (the first SIGTERM or SIGINT, runtime/cli.py) the loop
ends after its step and the exit path runs: a dirty device film is
fetched, a checkpoint is written between intervals, and whatever the
outfile lacks is saved.

Observability, as the reference's: named spans on a ``TraceChannel``
(utils/tracing.py) around each phase, on both threads, debug-level
tensor info of the scene and the env, ``--device-timing``
(utils/devtime.py) before the loop, ``--profile-dir`` (a
``torch.profiler`` trace of the render loop, both threads, written as
``trace.json`` in Chrome's format), ``--metrics-file`` (one JSON line per
step and a summary: the rate of the samples this run rendered, and each
span's count and seconds) and, on CUDA, one device-memory line after the
first step.  ``execute`` makes its channel the current one for the loop,
so the step's modules open spans on it: a step is ``ui_input``, then
``ipu_render`` (``compute_budgets``, ``shard_launch/<i>``,
``megastep_launch``, ``film_reduction``, then ``device_sync`` with
``card_sync/<k>``, or ``device_fetch``), ``wait_for_host`` and
``step_end``.  While a profiler records (``--profile-dir``, or an
embedding program's) the channel keeps each span, and K3 writes its
per-block records (utils/tracing.py).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import math
import os
import threading
import time

import numpy as np
import torch

from ..core.records import WorkBatch, from_device_batch, raster_permutation, to_device_batch
from ..core.scene import default_scene
from ..core.scenefile import load_scene
from ..film.debugview import debug_ldr, debug_view, mean_path_length
from ..film.denoise import (ALBEDO_FLOOR, denoise_hdr, filter_hdr, guides_numpy,
                            primary_features)
from ..film.film import Film, tone_map
from ..film.imageio import load_hdr_image, save_images
from ..models.envlight import ConstantEnv, NifEnv, TextureEnv, bake_nif_env
from ..models.nif import analyse_nif, load_nif_assets
from ..models.quant import quantize_nif
from ..parallel.mesh import (Replicated, Sharded, gather_work, make_mesh, replicate, shard_array,
                             shard_work, sharded_adaptive_render_step, sharded_render_step)
from ..render.adaptive import adaptive_render_step
from ..render.params import RenderSettings, StaticConfig
from ..render.wavefront import render_step
from ..utils.devtime import log_phase_split, measure_phases
from ..utils.introspect import log_tensor_info
from ..utils.tracing import TraceChannel
from . import native
from .async_task import AsyncTask
from .checkpoint import LAYOUT_KEYS, load_checkpoint, render_fingerprint, save_checkpoint
from .config import Config
from .worklist import LoadBalancer, coherent_order, create_tracing_jobs

log = logging.getLogger(__name__)

# Steps without UI interaction before the step size reverts from
# interactive_samples to samples_per_step (the reference's constant).
SAMPLE_COUNT_REVERSION_STEP = 5


def _raster_mean(work: WorkBatch, perm: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(H, W, 3) per-pixel means rgb / sampleCount of the running sums,
    gathered into raster order by ``perm`` (core/records.raster_permutation)."""
    cnt = torch.clamp_min(work.sample_count, 1).to(torch.float32)
    inv = torch.where(work.sample_count > 0, 1.0 / cnt, torch.zeros_like(cnt))
    rgb = [(c * inv)[perm] for c in (work.r, work.g, work.b)]
    return torch.stack(rgb, dim=-1).reshape(height, width, 3)


def _tone_map_device(rgb: torch.Tensor, exposure: float, gamma: float) -> torch.Tensor:
    """(x * 2^exposure)^(1/gamma) -> uint8, rounded half to even (rint)."""
    scaled = torch.clamp_min(rgb * (2.0 ** exposure), 0.0)
    ldr = torch.pow(scaled, 1.0 / gamma)
    return torch.clamp(torch.round(ldr * 255.0), 0.0, 255.0).to(torch.uint8)


def _device_preview(work: WorkBatch, perm: torch.Tensor, exposure: float, gamma: float, *,
                   width: int, height: int) -> torch.Tensor:
    """The device film's tone-mapped LDR preview (H, W, 3) uint8, computed
    where the running sums live: only H x W x 3 bytes leave the card."""
    return _tone_map_device(_raster_mean(work, perm, width, height), exposure, gamma)


def _device_preview_denoised(work: WorkBatch, perm: torch.Tensor, exposure: float, gamma: float,
                            albedo: torch.Tensor, normal: torch.Tensor, disparity: torch.Tensor,
                            sigma_colour: float, clamp: float, *, width: int, height: int,
                            iterations: int) -> torch.Tensor:
    """_device_preview of the à-trous-filtered means (``albedo`` floored at
    ALBEDO_FLOOR, as denoise_hdr floors it)."""
    hdr = _raster_mean(work, perm, width, height)
    rgb = filter_hdr(hdr, albedo, normal, disparity, iterations=iterations,
                     sigma_colour=sigma_colour, firefly_clamp_k=clamp)
    return _tone_map_device(rgb, exposure, gamma)


def resolve_device(name: str) -> torch.device:
    """The render device; a CUDA request without CUDA raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the port renders on "
                           "the CPU only when asked to (--device cpu)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported --device {name!r} (cuda or cpu)")
    return dev


def parse_env_assets(assets: str, device: torch.device, nif_precision: str = "auto",
                     partials_type: str = "half"):
    """Build the environment light from the --assets argument:
    'constant:R,G,B', 'texture:<file.exr>' or a NIF assets dir ->
    (env, (meta, weights) or None).

    ``partials_type`` (--partials-type) is the NIF's weight type, as the
    reference's: 'half' bf16 (the bf16 chain), 'float' f32 (the f32 chain,
    tf32 ``wgmma`` on the card).  ``nif_precision='int8'`` quantises the
    raw weights whatever the partials type, for the int8 chain
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
    dtype = torch.bfloat16 if partials_type == "half" else torch.float32
    model, meta, weights = load_nif_assets(assets, dtype, device)
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
        self.mesh = None  # the device mesh (parallel/mesh.py), or None: one device
        # What the step takes: the scene and env themselves, or their
        # replicas over the mesh.
        self._scene_arg = self._env_arg = None
        self.film: Film | None = None
        self.balancer: LoadBalancer | None = None
        self.worklist: np.ndarray | None = None  # the initial layout
        self.total_spp = 0
        self.trace = TraceChannel("tpu_path_tracer")
        self.stop_requested = False  # set by the CLI's signal handler
        # The loop's state shared with the host task; the main thread reads
        # it only after waiting for the task.
        self._disk_norm = 0  # the film's normalisation not yet on disk (0: none)
        self._ckpt_step = 0  # the last step checkpointed
        self._rays = 0  # the last cleared buffer's path-length sum
        self._rendered = 0  # samples a pixel the loop has rendered (its steps' samples_per_step)
        # The live render state: the CLI's values, then the remote UI's.
        self.state = {"exposure": config.exposure, "gamma": config.gamma, "fov": config.fov,
                      "env_rotation": config.env_map_rotation,
                      "interactive_samples": config.interactive_samples}
        self.samples_per_step = config.samples_per_step  # interactive_samples under a UI
        self.interactive = False
        self.active_assets = config.assets  # what lights the render (a UI may swap it)
        self._ui = None  # the attached UI server, None when headless or detached
        # --denoise / --debug-view guides for (fov, env rotation, assets):
        # (key, guide tensors, the event that follows their computation).
        self._guide_cache: tuple | None = None
        self._guide_lock = threading.Lock()
        self._preview_guides: tuple | None = None  # the device preview's floored guides
        self._debug_soa: tuple | None = None  # (u, v, pathLength, sampleCount) of a step
        self._side_stream: torch.cuda.Stream | None = None  # the host task's denoise

    def init(self) -> None:
        cfg = self.cfg
        if cfg.ipus > 1 or cfg.mesh_shape:
            # An explicit --mesh-shape forces the mesh path even at --ipus 1:
            # a 1x1 mesh runs the sharded step on one card.
            devices = [self.device] * max(1, cfg.ipus) if self.device.type == "cpu" else None
            self.mesh = make_mesh(cfg.ipus, cfg.mesh_shape, devices)
            log.info("Device mesh: %s on %s", self.mesh.shape,
                     ", ".join(str(d) for d in self.mesh.distinct()))
        self._scene_arg = self.scene if self.mesh is None else replicate(self.scene, self.mesh)
        self.total_spp = cfg.rounded_samples_per_pixel()
        if self.total_spp != cfg.samples:
            log.info("Rounding SPP to next multiple of %d  (Rounded SPP := %d)",
                     cfg.samples_per_step, self.total_spp)
        self._load_env(cfg.assets)

    def load_env(self, assets: str) -> bool:
        """Swap the environment light (the UI's load_nif); False, and the
        env unchanged, when it cannot be loaded."""
        try:
            self._load_env(assets)
        except Exception as e:  # noqa: BLE001 - a bad path from the UI must not end the render
            log.error("Could not load NIF model from '%s'. Exception: %s", assets, e,
                      exc_info=True)
            return False
        return True

    def _load_env(self, assets: str) -> None:
        cfg = self.cfg
        env, nif_info = parse_env_assets(assets, self.device, cfg.nif_precision,
                                         cfg.partials_type)
        env_arg = env if self.mesh is None else replicate(env, self.mesh)
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
                    # Each device of a mesh bakes its own replica.
                    baked = {d: bake_nif_env(e, int(h), int(w),
                                             max_batch_size=cfg.max_nif_batch_size)
                             for d, e in (env_arg.copies.items() if self.mesh is not None
                                          else [(self.device, env)])}
                    env = next(iter(baked.values()))
                    env_arg = env if self.mesh is None else Replicated(baked)
                    self._sync()
                log.info("Baked NIF env to %dx%d texture in %.3f seconds (--nif-mode baked)",
                         int(h), int(w), time.monotonic() - t0)
        self.env, self._env_arg = env, env_arg
        self.active_assets = assets

    def build(self) -> None:
        cfg = self.cfg
        native.library()  # builds the host runtime; a failure raises here, before the render
        n_px = self.mesh.shape["pixels"] if self.mesh is not None else 1
        with self.trace.span("create_path_tracing_jobs"):
            worklist = create_tracing_jobs(cfg.width, cfg.height, multiple_of=n_px)
            self.balancer = LoadBalancer(len(worklist))
            if cfg.enable_load_balancing:
                if cfg.layout == "coherent":
                    log.info("--enable-load-balancing overrides --layout with the reference's "
                             "shuffle + per-step re-deal")
                self.balancer.randomise_work_list(worklist)
            else:
                if cfg.layout == "coherent":
                    worklist = coherent_order(worklist, self.scene, cfg.width, cfg.height,
                                              cfg.fov, shards=n_px)
                self.balancer.work.inactive = worklist.copy()
            self.balancer.work.active = self.balancer.work.inactive.copy()
        self.worklist = self.balancer.work.active.copy()
        self.film = Film(cfg.width, cfg.height)
        if cfg.adaptive and not isinstance(self.env, NifEnv):
            raise ValueError("--adaptive requires a NIF environment (--assets <dir>); the "
                             "budget controller lives in the fused megastep")
        log_tensor_info("scene", self.scene)
        log_tensor_info("env", self.env)

    def local_samples(self, samples_per_step: int) -> int:
        """Each sample replica's share of a step's samples on a mesh."""
        if self.mesh is None:
            return samples_per_step
        sm = self.mesh.shape["samples"]
        if samples_per_step % sm:
            raise ValueError(f"samples-per-step {samples_per_step} must divide by the sample "
                             f"mesh axis ({sm})")
        return samples_per_step // sm

    def settings(self) -> RenderSettings:
        """The render settings of the live state: fov, env rotation and
        samples per step (the CLI's until a UI changes them; on a mesh each
        sample replica's share)."""
        cfg = self.cfg
        return RenderSettings.make(
            fov_degrees=self.state["fov"], aa_scale=cfg.aa_noise_scale,
            env_rotation_degrees=self.state["env_rotation"],
            refractive_index=cfg.refractive_index, stop_prob=cfg.stop_prob,
            roulette_depth=cfg.roulette_depth,
            samples_per_step=self.local_samples(self.samples_per_step),
            aperture=cfg.aperture, focal_distance=cfg.focal_distance, seed=cfg.seed)

    def _settings_sig(self) -> tuple:
        return self.samples_per_step, self.state["fov"], self.state["env_rotation"]

    def static_config(self) -> StaticConfig:
        cfg = self.cfg
        return StaticConfig(width=cfg.width, height=cfg.height,
                            max_path_length=cfg.max_path_length,
                            aa_noise_type=cfg.aa_noise_type,
                            use_fused_step=cfg.use_fused_step,
                            adaptive_min=cfg.adaptive_min,
                            adaptive_max_factor=cfg.adaptive_max_factor,
                            sampler=cfg.sampler,
                            sobol_dims=cfg.sobol_dims)

    def _sync(self) -> None:
        if self.mesh is not None:
            self.mesh.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _on_device(self, x: torch.Tensor | WorkBatch) -> torch.Tensor | WorkBatch | Sharded:
        """A whole-frame tensor or worklist on the render's device, or split
        over the mesh."""
        if self.mesh is not None:
            return (shard_array if isinstance(x, torch.Tensor) else shard_work)(x, self.mesh)
        return x.to(self.device) if isinstance(x, torch.Tensor) else WorkBatch(
            *(t.to(self.device) for t in x))

    def _upload(self, records: np.ndarray) -> WorkBatch | Sharded:
        """Host records on the render's device, or split over the mesh."""
        return self._on_device(to_device_batch(records, "cpu"))

    def _render(self, settings: RenderSettings, static: StaticConfig, work, seed, **kw):
        """One render step on the device, or sharded over the mesh."""
        if self.mesh is None:
            return render_step(self.scene, settings, static, work, seed, self.env, **kw)
        return sharded_render_step(self._scene_arg, settings, static, work, seed, self._env_arg,
                                   self.mesh, **kw)

    def _render_adaptive(self, settings: RenderSettings, static: StaticConfig, work, lum2, seed):
        """One adaptive step on the device, or sharded over the mesh."""
        if self.mesh is None:
            return adaptive_render_step(self.scene, settings, static, work, lum2, seed, self.env)
        return sharded_adaptive_render_step(self._scene_arg, settings, static, work, lum2, seed,
                                            self._env_arg, self.mesh)

    @staticmethod
    def _whole(x, device) -> torch.Tensor | WorkBatch:
        """A sharded worklist or array gathered on ``device``; anything else
        as it is."""
        return gather_work(x, device) if isinstance(x, Sharded) else x

    def execute(self, ui_server=None, max_steps: int | None = None) -> Film:
        """Render ``total_spp / samples_per_step`` steps (at most
        ``max_steps``) into the film, resuming where asked, under the
        remote UI ``ui_server`` (ui/server.py) when given."""
        cfg = self.cfg
        steps = self.total_spp // cfg.samples_per_step
        if max_steps is not None:
            steps = min(steps, max_steps)
        self._ui = ui_server
        if ui_server is not None:
            self.samples_per_step = self.state["interactive_samples"]
            self.interactive = True
            # The protocol's defaults must not overwrite the CLI's values
            # on the first state change; what the client sent wins.
            ui_server.seed_state(dict(self.state))
        gen = torch.Generator().manual_seed(cfg.seed)  # per-step kernel seed words
        done, work, lum2 = self._resume()
        for _ in range(done):  # the seeds of the steps already rendered
            step_seed(gen)
        if cfg.device_timing:
            self._device_timing()
        start = time.monotonic()
        log.info("Render started on %s (%s film)", self.device if self.mesh is None else self.mesh,
                 "device" if cfg.device_film else "host")
        host = AsyncTask()
        self._rendered = 0
        with (self._profiler() if cfg.profile_dir else contextlib.nullcontext() as prof,
              self.trace.loop()):
            try:
                if cfg.device_film:
                    self._device_film_steps(done + 1, steps, gen, host, work, lum2)
                else:
                    self._host_film_steps(done + 1, steps, gen, host)
            finally:
                host.wait_for_completion()  # no task outlives the loop, on any exit
        elapsed = time.monotonic() - start
        if prof is not None:
            self._write_profile(prof)
        # The samples this run rendered: a stop or max_steps ends the loop
        # before total_spp.
        rate = cfg.width * cfg.height * self._rendered / elapsed
        chips = self.mesh.size if self.mesh is not None else 1
        log.info("Render finished: %.3f seconds (Samples/sec: %.4g)", elapsed, rate)
        log.info("Samples/sec/chip: %.4g", rate / chips)
        self._emit_metrics({"event": "summary", "elapsed_seconds": round(elapsed, 3),
                            "total_spp": int(self.total_spp),
                            "samples_per_sec": round(rate, 1), "chips": chips,
                            "spans": self.trace.report()})
        return self.film

    def _resume(self) -> tuple[int, WorkBatch | None, torch.Tensor | None]:
        """--resume / --auto-resume: restore the checkpoint's state.
        Returns (steps done, the device film's worklist, its lum2)."""
        cfg = self.cfg
        path = cfg.resume
        if not path and cfg.auto_resume:
            if os.path.exists(cfg.checkpoint):
                path = cfg.checkpoint
            else:
                log.info("--auto-resume: no checkpoint at '%s'; starting afresh", cfg.checkpoint)
        if not path:
            return 0, None, None
        done, mode, saved = load_checkpoint(path, cfg)
        if mode != ("soa" if cfg.device_film else "hdr"):
            raise ValueError(f"checkpoint mode '{mode}' does not match this run")
        layouts = saved.pop("layouts")
        work = lum2 = None
        if cfg.device_film:
            lum2_saved = saved.pop("lum2", None)
            if set(saved) != set(WorkBatch._fields):
                raise ValueError(f"checkpoint '{path}' holds {sorted(saved)}, not a worklist")
            work = self._on_device(WorkBatch(*(torch.from_numpy(saved[k])
                                               for k in WorkBatch._fields)))
            if cfg.adaptive:
                if lum2_saved is None:
                    raise ValueError("checkpoint has no adaptive lum2 state; it was written "
                                     "without --adaptive")
                lum2 = self._on_device(torch.from_numpy(lum2_saved))
        else:
            if saved["hdr"].shape != self.film.hdr.shape:
                raise ValueError(f"checkpoint film {saved['hdr'].shape} != {self.film.hdr.shape}")
            self.film.hdr[...] = saved["hdr"]
            self._disk_norm = done  # not on disk in this run yet
            if cfg.enable_load_balancing:
                # Both buffers' layouts, accumulators zeroed (they were
                # saved after the clear).
                if set(layouts) != set(LAYOUT_KEYS):
                    raise ValueError("checkpoint has no load-balancer layouts; it was written "
                                     "without --enable-load-balancing")
                for name in ("active", "inactive"):
                    buf = getattr(self.balancer.work, name)
                    if len(layouts[f"{name}_u"]) != len(buf):
                        raise ValueError(f"checkpoint worklist size {len(layouts[f'{name}_u'])} "
                                         f"!= {len(buf)}")
                    buf[...] = 0
                    buf["u"], buf["v"] = layouts[f"{name}_u"], layouts[f"{name}_v"]
        log.info("Resumed from '%s': %d steps already rendered", path, done)
        return done, work, lum2

    def _device_timing(self) -> None:
        """--device-timing: the per-sample phase split at the render's
        shapes, before the loop (utils/devtime.py), on the first step's
        seed words; the render's own stream is untouched."""
        if self.cfg.adaptive:
            log.warning("--device-timing with --adaptive reports the uniform step's phase "
                        "split (the adaptive schedule shifts samples between blocks)")
        seed = step_seed(torch.Generator().manual_seed(self.cfg.seed))
        with self.trace.span("device_timing"):
            split = measure_phases(self._scene_arg, self.settings(), self.static_config(),
                                   to_device_batch(self.worklist, self.device), seed,
                                   self._env_arg, mesh=self.mesh)
        log_phase_split(split)

    def _profiler(self) -> torch.profiler.profile:
        """--profile-dir: the render loop under torch.profiler, the card's
        kernels included on CUDA, and the host task's spans beside the main
        thread's (without profile_all_threads the profiler records the
        thread that started it only)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        log.info("Profiler trace -> '%s'", self.cfg.profile_dir)
        from torch._C._profiler import _ExperimentalConfig

        return torch.profiler.profile(
            activities=acts, experimental_config=_ExperimentalConfig(profile_all_threads=True))

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

    def _after_step(self, step: int, first: int, steps: int, secs: float, **extra) -> None:
        cfg = self.cfg
        self._rendered += self.samples_per_step
        rate = cfg.width * cfg.height * self.samples_per_step / secs
        self._emit_metrics({"step": step, "steps": steps, "seconds": round(secs, 4),
                            "samples_per_sec": round(rate, 1), **extra,
                            "spp_per_step": self.samples_per_step})
        if self._ui is not None:
            self._ui.update_sample_rate(rate, extra.get("rays_per_sec", 0.0))
        if step == first:
            self._log_device_memory()

    def _stop(self, done: int) -> bool:
        if self.stop_requested:
            log.info("Stop requested (signal); exiting after step %d", done)
        return self.stop_requested

    def _write_checkpoint(self, step: int, fingerprint: dict, **state) -> None:
        """--checkpoint at ``step`` (once per step), with the load
        balancer's two layouts on the host film."""
        cfg = self.cfg
        if not cfg.checkpoint or step <= self._ckpt_step:
            return
        layouts = None
        if cfg.enable_load_balancing:
            work = self.balancer.work
            layouts = {"active_u": work.active["u"].copy(), "active_v": work.active["v"].copy(),
                       "inactive_u": work.inactive["u"].copy(),
                       "inactive_v": work.inactive["v"].copy()}
        with self.trace.span("checkpoint"):
            save_checkpoint(cfg.checkpoint, cfg, step, layouts=layouts, fingerprint=fingerprint,
                            **state)
        self._ckpt_step = step

    def _fingerprint(self) -> dict:
        """The checkpoint fingerprint of what lights the samples now: the
        live fov, env rotation and assets, which the UI may have changed."""
        fp = render_fingerprint(self.cfg)
        fp.update(fov=float(self.state["fov"]), env_map_rotation=float(self.state["env_rotation"]),
                  assets=self.active_assets)
        return fp

    # --- guides, denoise and debug views ------------------------------------------------------

    def _guides(self, state: dict) -> dict:
        """The --denoise / --debug-view guide tensors for ``state``'s camera
        and env, cached per (fov, env rotation, assets); the caller's
        stream waits for their computation, wherever it ran."""
        cfg = self.cfg
        key = (float(state["fov"]), float(state["env_rotation"]), self.active_assets)
        with self._guide_lock:
            if self._guide_cache is None or self._guide_cache[0] != key:
                with self.trace.span("denoise_guides"):
                    guides = primary_features(self.scene, cfg.width, cfg.height,
                                              math.radians(key[0]), env=self.env,
                                              azimuth=math.radians(key[1]),
                                              max_batch=cfg.max_nif_batch_size)
                done = None
                if self.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
                self._guide_cache = (key, guides, done)
                self._preview_guides = None  # the device copies follow the key
            _, guides, done = self._guide_cache
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        return guides

    def _stream(self):
        """The host task's CUDA stream for the denoiser (a context manager;
        nothing on the CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._side_stream)

    def _denoise(self, hdr: np.ndarray, state: dict) -> np.ndarray:
        """--denoise of a step-normalised HDR image on the app's device, on
        the side stream: the host task's filter does not wait for the render
        step queued on the main one."""
        cfg = self.cfg
        with self._stream():
            guides = self._guides(state)
            with self.trace.span("denoise"):
                return denoise_hdr(hdr, guides, iterations=cfg.denoise_iters,
                                   sigma_colour=cfg.denoise_sigma,
                                   firefly_clamp=cfg.denoise_clamp, device=self.device)

    def _ldr(self, norm: int, state: dict, hdr: np.ndarray | None = None) -> np.ndarray:
        """The film at normalisation ``norm`` (or ``hdr``), tone-mapped with
        the state's exposure and gamma."""
        if hdr is None:
            return self.film.ldr(norm, state["exposure"], state["gamma"])
        return tone_map(hdr, 1, state["exposure"], state["gamma"], self.film.native)

    def _save(self, norm: int, step: int, state: dict, at_exit: bool = False) -> None:
        """Write -o: the film at normalisation ``norm``, denoised with
        --denoise, or the --debug-view channel in its place."""
        cfg = self.cfg
        t0 = time.monotonic()
        with self.trace.span("save_images"):
            self._disk_norm = 0
            if cfg.debug_view:
                plm = None
                if cfg.debug_view == "path-length":
                    if self._debug_soa is None:
                        log.warning("--debug-view path-length: no worklist fetched yet; "
                                    "writing a zero heat map")
                        plm = np.zeros((cfg.height, cfg.width), np.float32)
                    else:
                        plm = mean_path_length(*self._debug_soa, cfg.width, cfg.height)
                with self._stream():
                    guides = guides_numpy(self._guides(state))
                with self.trace.span("debug_view"):
                    img = debug_view(cfg.debug_view, guides, plm, cfg.max_path_length)
                save_images(cfg.outfile, img, debug_ldr(img, state["gamma"]))
            elif cfg.denoise:
                hdr = self._denoise(self.film.hdr_at_step(norm), state)
                save_images(cfg.outfile, hdr, self._ldr(1, state, hdr))
            else:
                save_images(cfg.outfile, self.film.hdr_at_step(norm), self._ldr(norm, state))
        log.info("Saved images at %s in %.3f seconds", f"exit (step {step})" if at_exit
                 else f"step {step}", time.monotonic() - t0)

    def _finish(self, done: int, **state) -> None:
        """The exit path, once the last task is done: checkpoint between
        intervals and save what the outfile lacks."""
        self._write_checkpoint(done, self._fingerprint(), **state)
        if self._disk_norm:
            self._save(self._disk_norm, done, self.state, at_exit=True)

    # --- the remote UI ------------------------------------------------------------------------

    def _ui_input(self, step: int, host: AsyncTask) -> str:
        """Apply the client's state before a step: "stop", "restart" (the
        caller resets the render; the host task is done) or "none".  After
        SAMPLE_COUNT_REVERSION_STEP quiet steps the step size reverts to
        samples_per_step."""
        cfg = self.cfg
        ui = self._ui
        if ui is not None and ui.state_changed():
            with self.trace.span("ui_processing"):
                status = self._process_user_input(ui.consume_state())
            if status == "disconnected":
                self._ui = None
                return "none"
            if status == "restart":
                host.wait_for_completion()
                self.samples_per_step = self.state["interactive_samples"]
            return status
        if (step >= SAMPLE_COUNT_REVERSION_STEP and self.interactive
                and self.samples_per_step != cfg.samples_per_step):
            # >=: a UI event on the reversion step itself still reverts on
            # the next quiet one.
            self.samples_per_step = cfg.samples_per_step
            self.interactive = ui is not None
            log.debug("Interaction stopped reverting samples per step to: %d",
                      self.samples_per_step)
        return "none"

    def _process_user_input(self, ui_state: dict) -> str:
        """The client's state -> "stop", "disconnected", "restart" or
        "none".  Wire values are untrusted: an invalid interactive_samples
        is logged and ignored, a NIF that fails to load keeps the current
        env, and a message that changes nothing does not restart."""
        state = self.state
        if ui_state.get("stop"):
            log.info("Rendering stopped by remote UI")
            return "stop"
        if ui_state.get("detach"):
            log.info("Remote UI disconnected.")
            return "disconnected"
        new_nif = ui_state.get("load_nif")
        changed = False
        if new_nif:
            log.info("Loading NIF: %s", new_nif)
            changed = self.load_env(new_nif)
        for k in ("exposure", "gamma"):  # the tone map only: never a restart
            if k in ui_state:
                state[k] = float(ui_state[k])
        for k in ("env_rotation", "fov"):
            if k in ui_state:
                if float(ui_state[k]) != float(state[k]):
                    changed = True
                state[k] = float(ui_state[k])
        if "interactive_samples" in ui_state:
            v = int(ui_state["interactive_samples"])
            sm = self.mesh.shape["samples"] if self.mesh is not None else 1
            if v < 1:
                log.warning("Ignoring invalid interactive_samples=%d from UI: must be >= 1", v)
            elif v > 0xFFFF and not self.cfg.device_film:
                log.warning("Ignoring invalid interactive_samples=%d from UI: > 65535 needs "
                            "--device-film (u16 wire clip)", v)
            elif v % sm:
                log.warning("Ignoring invalid interactive_samples=%d from UI: must divide by "
                            "the sample mesh axis (%d)", v, sm)
            else:
                changed = changed or v != state["interactive_samples"]
                state["interactive_samples"] = v
        return "restart" if changed else "none"

    def _live_tone(self, ui, state: dict) -> dict:
        """``state`` with the client's current exposure and gamma, which
        apply at once (no restart)."""
        live = ui.get_state()
        self.state["exposure"], self.state["gamma"] = live["exposure"], live["gamma"]
        return {**state, "exposure": live["exposure"], "gamma": live["gamma"]}

    # --- the host film ------------------------------------------------------------------------

    def _host_film_steps(self, first: int, steps: int, gen: torch.Generator,
                         host: AsyncTask) -> None:
        """Each step renders the active buffer into zeroed accumulators
        and fetches its records into it; the host task takes them after
        the swap (module docstring)."""
        cfg = self.cfg
        static = self.static_config()
        settings, sig = self.settings(), self._settings_sig()
        work = self.balancer.work
        work_dev = None  # uploaded once, or every step under load balancing
        # The counts restart at 0 every step, so the Sobol sampler is told
        # how many samples each lane already has.
        sobol_base = (first - 1) * cfg.samples_per_step
        done = first - 1
        step = first
        while step <= steps:
            if self._stop(done):
                break
            t0 = time.monotonic()
            self.trace.step = step
            with self.trace.span("ui_input"):
                status = self._ui_input(step, host)
            if status == "stop":
                break
            if status == "restart":
                self.film.reset()
                self.balancer.clear_active_accumulators()
                self._disk_norm = self._ckpt_step = sobol_base = done = 0
                gen = torch.Generator().manual_seed(cfg.seed)
                step = self.trace.step = 1
            if self._settings_sig() != sig:
                settings, sig = self.settings(), self._settings_sig()
            with self.trace.span("ipu_render"):
                if work_dev is None or cfg.enable_load_balancing:
                    work_dev = self._upload(work.active)
                out = self._render(settings, static, work_dev, step_seed(gen),
                                   sobol_base=sobol_base)
                with self.trace.span("device_fetch"):  # the fetch waits for the device(s)
                    work.active = from_device_batch(self._whole(out, "cpu"))
            sobol_base += self.samples_per_step
            t1 = time.monotonic()
            with self.trace.span("wait_for_host"):
                host.wait_for_completion()
            t2 = time.monotonic()
            work.swap()
            rays = self._rays  # the step before's, as the reference's Rays/sec
            host.run(functools.partial(self._host_processing, step, steps, self._fingerprint(),
                                       dict(self.state), self._ui))
            with self.trace.span("step_end"):
                secs = time.monotonic() - t0
                rate = cfg.width * cfg.height * self.samples_per_step / secs
                log.info("Completed render step %d/%d in %.3f seconds (render+fetch %.3f, wait "
                         "for host %.3f; Samples/sec %.3g) (Rays/sec %.3g)", step, steps, secs,
                         t1 - t0, t2 - t1, rate, rays / secs)
                self._after_step(step, first, steps, secs, rays_per_sec=round(rays / secs, 1))
            done = step
            step += 1
        with self.trace.span("wait_for_host"):
            host.wait_for_completion()
        self._finish(done, hdr=self.film.hdr)

    def _host_processing(self, step: int, steps: int, fingerprint: dict, state: dict,
                         ui) -> None:
        """The host task of a host-film step, on the inactive buffer: the
        film, the UI's preview and progress, the re-deal, the clear, and
        at save steps the checkpoint and the images (streamed to a UI)."""
        cfg = self.cfg
        inactive = self.balancer.work.inactive
        with self.trace.span("accumulate_framebuffers"):
            self.film.accumulate(inactive)
        if cfg.debug_view == "path-length":  # copies: the clear below zeroes them
            self._debug_soa = tuple(inactive[k].copy() for k in ("u", "v", "pathLength",
                                                                 "sampleCount"))
        self._disk_norm = step
        if ui is not None:
            state = self._live_tone(ui, state)
            with self.trace.span("tone_map"):
                hdr = self._denoise(self.film.hdr_at_step(step), state) if cfg.denoise else None
                ldr = self._ldr(step, state, hdr)
            with self.trace.span("ui_encode"):
                ui.send_preview_image(ldr)
            ui.update_progress(step, steps)
        if cfg.enable_load_balancing and step > 1:
            with self.trace.span("run_load_balancing"):
                self.balancer.allocate_work_by_path_length()
        with self.trace.span("clear_accumulators"):
            self._rays = self.balancer.clear_inactive_accumulators()
        if step % cfg.save_interval == 0 or step == steps:
            self._write_checkpoint(step, fingerprint, hdr=self.film.hdr)
            if ui is not None:
                ui.start_sending_raw_image(self.film.hdr_at_step(step))
            else:
                self._save(step, step, state)

    # --- the device film ----------------------------------------------------------------------

    def _fetch(self, work: WorkBatch, lum2: torch.Tensor | None) -> dict[str, np.ndarray]:
        """The device film's sums on the host (int32 counts: no u16 wire
        record on this path), with the adaptive second moments."""
        work, lum2 = self._whole(work, "cpu"), self._whole(lum2, "cpu")
        soa = {k: t.cpu().numpy() for k, t in zip(WorkBatch._fields, work)}
        if lum2 is not None:
            soa["lum2"] = lum2.cpu().numpy()
        return soa

    def _rebuild_film(self, soa: dict[str, np.ndarray]) -> None:
        """The running sums' rgb / sampleCount is each pixel's mean, so
        the rebuilt film saves at normalisation 1."""
        self.film.reset()
        self.film.accumulate_soa(soa["u"], soa["v"], soa["r"], soa["g"], soa["b"],
                                 soa["sample_count"])
        self._debug_soa = (soa["u"], soa["v"], soa["path_length"], soa["sample_count"])
        self._disk_norm = 1

    def _preview(self, work: WorkBatch, perm: torch.Tensor, state: dict) -> np.ndarray:
        """The device film's LDR preview, computed on the render's device
        (denoised with --denoise); only its H x W x 3 bytes are fetched."""
        cfg = self.cfg
        kw = dict(width=cfg.width, height=cfg.height)
        if not cfg.denoise:
            ldr = _device_preview(work, perm, state["exposure"], state["gamma"], **kw)
            return ldr.cpu().numpy()
        guides = self._guides(state)
        if self._preview_guides is None:
            self._preview_guides = (torch.clamp_min(guides["albedo"], ALBEDO_FLOOR),
                                    guides["normal"], guides["disparity"])
        return _device_preview_denoised(work, perm, state["exposure"], state["gamma"],
                                        *self._preview_guides, cfg.denoise_sigma,
                                        cfg.denoise_clamp, iterations=cfg.denoise_iters,
                                        **kw).cpu().numpy()

    def _device_film_steps(self, first: int, steps: int, gen: torch.Generator, host: AsyncTask,
                           work: WorkBatch | None, lum2: torch.Tensor | None) -> None:
        """The worklist (and, adaptive, the second moments) stay on the
        device; at save steps the main thread fetches them and the host
        task rebuilds the film, checkpoints and saves (streams to a UI).
        Under a UI the main thread sends a preview computed on the device
        every step."""
        cfg = self.cfg
        static = self.static_config()
        settings, sig = self.settings(), self._settings_sig()
        dirty = work is not None  # a resumed film is not on disk in this run
        if work is None:
            work = self._upload(self.worklist)
        if cfg.adaptive and lum2 is None:
            lum2 = self._on_device(torch.zeros(len(self.worklist), dtype=torch.float32))
        perm = None  # the raster gather of the previews
        done = first - 1
        step = first
        while step <= steps:
            if self._stop(done):
                break
            t0 = time.monotonic()
            self.trace.step = step
            with self.trace.span("ui_input"):
                status = self._ui_input(step, host)
            if status == "stop":
                break
            if status == "restart":
                self.film.reset()
                work = self._upload(self.worklist)
                if cfg.adaptive:
                    lum2 = self._on_device(torch.zeros(len(self.worklist), dtype=torch.float32))
                self._disk_norm = self._ckpt_step = done = 0
                dirty = False
                gen = torch.Generator().manual_seed(cfg.seed)
                step = self.trace.step = 1
            if self._settings_sig() != sig:
                settings, sig = self.settings(), self._settings_sig()
            save = step % cfg.save_interval == 0 or step == steps
            with self.trace.span("ipu_render"):
                if cfg.adaptive:
                    work, lum2 = self._render_adaptive(settings, static, work, lum2,
                                                       step_seed(gen))
                else:
                    work = self._render(settings, static, work, step_seed(gen))
                if save:
                    with self.trace.span("device_fetch"):  # the fetch waits for the device
                        soa = self._fetch(work, lum2)
                else:
                    # The step's seconds are the device's, not the enqueue's.
                    with self.trace.span("device_sync"):
                        self._sync()
            t1 = time.monotonic()
            with self.trace.span("wait_for_host"):
                host.wait_for_completion()
            t2 = time.monotonic()
            ui = self._ui
            if ui is not None:
                if perm is None:
                    perm = torch.from_numpy(raster_permutation(
                        self.worklist, cfg.width, cfg.height).astype(np.int64)).to(self.device)
                tone = self._live_tone(ui, self.state)
                with self.trace.span("ui_preview"):
                    ldr = self._preview(self._whole(work, self.device), perm, tone)
                with self.trace.span("ui_encode"):
                    ui.send_preview_image(ldr)
                ui.update_progress(step, steps)
            if save:
                host.run(functools.partial(self._device_film_processing, step, soa,
                                           self._fingerprint(), dict(self.state), ui))
            dirty = not save
            with self.trace.span("step_end"):
                secs = time.monotonic() - t0
                rate = cfg.width * cfg.height * self.samples_per_step / secs
                log.info("Completed render step %d/%d in %.3f seconds (render%s %.3f, wait for "
                         "host %.3f; Samples/sec %.3g)", step, steps, secs,
                         "+fetch" if save else "", t1 - t0, t2 - t1, rate)
                self._after_step(step, first, steps, secs)
            done = step
            step += 1
        with self.trace.span("wait_for_host"):
            host.wait_for_completion()
        state = {}
        if dirty:  # samples newer than the film: fetch them for the exit path
            with self.trace.span("final_fetch"):
                state["soa"] = self._fetch(work, lum2)
                self._rebuild_film(state["soa"])
            if self._ui is not None:
                self._ui.start_sending_raw_image(self.film.hdr_at_step(1))
        self._finish(done, **state)

    def _device_film_processing(self, step: int, soa: dict[str, np.ndarray],
                                fingerprint: dict, state: dict, ui) -> None:
        """The host task of a device-film save step."""
        with self.trace.span("accumulate_framebuffers"):
            self._rebuild_film(soa)
        self._write_checkpoint(step, fingerprint, soa=soa)
        if ui is not None:
            ui.start_sending_raw_image(self.film.hdr_at_step(1))
        else:
            self._save(1, step, state)


def step_seed(gen: torch.Generator) -> tuple[int, int]:
    """The next two uint32 seed words of the kernels' Philox stream."""
    return tuple(int(x) for x in torch.randint(0, 1 << 32, (2,), generator=gen))
