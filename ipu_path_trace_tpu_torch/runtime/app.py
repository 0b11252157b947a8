"""The headless progressive render loop.

Counterpart of the host-film path of
``ipu_path_trace_tpu/runtime/app.py``: build the (coherent) worklist,
then per step run ``render_step`` on the device, fetch the records,
accumulate them into the host ``Film``, and write PNG + EXR at every
``save_interval`` and at the last step.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from ..core.records import from_device_batch, to_device_batch
from ..core.scene import default_scene
from ..film.film import Film
from ..film.imageio import load_hdr_image, save_images
from ..models.envlight import ConstantEnv, NifEnv, TextureEnv, bake_nif_env
from ..models.nif import analyse_nif, load_nif_assets
from ..models.quant import quantize_nif
from ..render.params import RenderSettings, StaticConfig
from ..render.wavefront import render_step
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
    def __init__(self, config: Config):
        self.cfg = config
        self.device = resolve_device(config.device)
        self.scene = default_scene(self.device)
        self.env = None
        self.film: Film | None = None
        self.worklist: np.ndarray | None = None
        self.total_spp = 0

    def init(self) -> None:
        cfg = self.cfg
        self.total_spp = cfg.rounded_samples_per_pixel()
        if self.total_spp != cfg.samples:
            log.info("Rounding SPP to next multiple of %d  (Rounded SPP := %d)",
                     cfg.samples_per_step, self.total_spp)
        if cfg.env_skip == "on":
            raise NotImplementedError("--env-skip is not ported yet (ROADMAP.md queue 1 item 11)")
        if cfg.env_skip == "auto":
            log.info("--env-skip auto resolves to off: the env-skip guard is not ported "
                     "yet (ROADMAP.md queue 1 item 11)")
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
                self.env = bake_nif_env(self.env, int(h), int(w),
                                        max_batch_size=cfg.max_nif_batch_size)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                log.info("Baked NIF env to %dx%d texture in %.3f seconds (--nif-mode baked)",
                         int(h), int(w), time.monotonic() - t0)

    def build(self) -> None:
        cfg = self.cfg
        worklist = create_tracing_jobs(cfg.width, cfg.height)
        if cfg.layout == "coherent":
            worklist = coherent_order(worklist, self.scene, cfg.width, cfg.height, cfg.fov)
        self.worklist = worklist
        self.film = Film(cfg.width, cfg.height)

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
                            use_fused_step=cfg.use_fused_step)

    def execute(self) -> Film:
        """Render ``total_spp / samples_per_step`` steps into the film."""
        cfg = self.cfg
        film = self.film
        steps = self.total_spp // cfg.samples_per_step
        settings, static = self.settings(), self.static_config()
        # Accumulators start at zero every step; the film keeps the sums.
        work = to_device_batch(self.worklist, self.device)
        gen = torch.Generator().manual_seed(cfg.seed)  # per-step kernel seed words
        start = time.monotonic()
        log.info("Render started on %s", self.device)
        for step in range(1, steps + 1):
            t0 = time.monotonic()
            seed = tuple(int(x) for x in torch.randint(0, 1 << 32, (2,), generator=gen))
            out = render_step(self.scene, settings, static, work, seed, self.env)
            records = from_device_batch(out)  # the fetch waits for the device
            t1 = time.monotonic()
            film.accumulate(records)
            t2 = time.monotonic()
            rate = cfg.width * cfg.height * cfg.samples_per_step / (t2 - t0)
            log.info("Completed render step %d/%d in %.3f seconds (render+fetch %.3f, "
                     "film %.3f; Samples/sec %.3g)", step, steps, t2 - t0, t1 - t0,
                     t2 - t1, rate)
            if step % cfg.save_interval == 0 or step == steps:
                save_images(cfg.outfile, film.hdr_at_step(step),
                            film.ldr(step, cfg.exposure, cfg.gamma))
                log.info("Saved images at step %d in %.3f seconds", step,
                         time.monotonic() - t2)
        elapsed = time.monotonic() - start
        log.info("Render finished: %.3f seconds (Samples/sec: %.4g)", elapsed,
                 cfg.width * cfg.height * self.total_spp / elapsed)
        return film
