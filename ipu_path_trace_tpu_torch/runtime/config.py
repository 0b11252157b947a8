"""Application configuration of the port's headless renderer.

Counterpart of ``ipu_path_trace_tpu/runtime/config.py`` for the flags
the port has: the same names, defaults and validation, plus ``device``.
The reference flags the port maps onto others, accepts and ignores, or
rejects are settled in runtime/cli.py.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    outfile: str = "out.png"
    save_interval: int = 1
    width: int = 256
    height: int = 256
    samples: int = 512
    samples_per_step: int = 512
    # Samples per step while a remote UI interacts (runtime/app.py reverts
    # to samples_per_step after SAMPLE_COUNT_REVERSION_STEP quiet steps).
    interactive_samples: int = 8
    refractive_index: float = 1.5
    roulette_depth: int = 3
    stop_prob: float = 0.3
    aa_noise_scale: float = 0.3
    fov: float = 90.0  # degrees
    exposure: float = 0.0
    gamma: float = 2.2
    env_map_rotation: float = 0.0  # degrees
    seed: int = 1
    aa_noise_type: str = "normal"
    max_path_length: int = 10
    assets: str = ""  # NIF assets dir, "constant:r,g,b" or "texture:<file.exr>"
    aperture: float = 0.0
    focal_distance: float = 1.0
    layout: str = "coherent"  # coherent | raster
    # The reference's dynamic load balancing: the seed-142 shuffle of the
    # worklist (in place of --layout) and a re-deal of each step's records
    # by path length (runtime/worklist.py LoadBalancer).  Host film only.
    enable_load_balancing: bool = False
    # Dead-block env-skip: the reference's megastep skips the NIF chain for
    # sub-tiles whose escape weights are all zero (exact).  K3 shades
    # escaping rays only (csrc/megastep.cuh's queue), so every value renders
    # the same; the option is parsed, validated and fingerprinted alone.
    env_skip: str = "auto"
    # The NIF's weight type, as the reference's --partials-type: "half" bf16
    # (the bf16 chain), "float" f32 (the f32 chain, tf32 wgmma on the card).
    partials_type: str = "half"
    # "auto" runs the NIF as --partials-type loads it; "int8" quantises the
    # raw weights for the int8 chain (models/quant.py), whatever the
    # partials type, with a QAT asset's quant_amax.json.
    nif_precision: str = "auto"
    # "fused" evaluates the NIF per escaped ray; "baked" decodes it once
    # into an equirect texture (models/envlight.bake_nif_env) of the
    # asset's original_image_shape, in chunks of max_nif_batch_size.
    nif_mode: str = "fused"
    max_nif_batch_size: int = 30 * 1472
    # JSON scene description (core/scenefile.py); "" = the reference's
    # built-in scene.
    scene: str = ""
    # Keep the worklist on the device between steps and fetch it only at
    # save-interval and at the last step; the film is rebuilt from the
    # running sums (int32 counts, so no u16 wire limit).
    device_film: bool = False
    # Checkpoint/resume (runtime/checkpoint.py): --checkpoint writes the
    # progressive state (.npz) at every save and at exit; --resume
    # continues from one bit for bit; --auto-resume resumes from
    # --checkpoint when that file exists and starts afresh when it does not.
    checkpoint: str = ""
    resume: str = ""
    auto_resume: bool = False
    # Adaptive per-block sampling (render/adaptive.py): Neyman allocation
    # of each step's samples across budget blocks by luminance variance.
    # Needs --device-film and the fused NIF megastep.
    adaptive: bool = False
    adaptive_min: int = 8  # per-block budget floor (samples/step)
    adaptive_max_factor: float = 16.0  # budget cap = factor * samples-per-step
    # "prng": Philox uniforms; "sobol": the Owen-scrambled Sobol sequence
    # (render/qmc.py) on the first sobol_dims path dimensions, Philox past.
    sampler: str = "prng"
    sobol_dims: int = 12  # camera (4) + whole bounces (4 each)
    # Observability (utils/): the log level (trace, debug, info, warn, err,
    # critical, off); a torch.profiler trace of the render loop written to
    # <profile_dir>/trace.json; the per-sample device phase split logged
    # before the loop (utils/devtime.py); one JSON line per step and a
    # summary appended to metrics_file.
    log_level: str = "info"
    profile_dir: str = ""
    device_timing: bool = False
    metrics_file: str = ""
    # The remote UI (ui/server.py): 0 renders headless; a port makes the
    # CLI wait for one client, then stream previews and take its state.
    ui_port: int = 0
    # À-trous denoiser (film/denoise.py) on the saved images and the
    # previews; the accumulator stays raw.
    denoise: bool = False
    denoise_iters: int = 4  # dilation passes (filter radius 2^n)
    denoise_sigma: float = 1.0  # log-luminance edge-stop
    denoise_clamp: float = 10.0  # firefly clamp: k x the 3x3 median (0 = off)
    # A diagnostic channel saved instead of radiance (film/debugview.py):
    # "" | normal | albedo | depth | path-length | escape-uv.
    debug_view: str = ""
    # Where the render runs.  "cuda" launches the kernels; "cpu" runs
    # their plain versions (the port's simulator; the reference's --model
    # maps here).  A CUDA request on a machine without CUDA raises:
    # nothing falls back to the CPU.
    device: str = "cuda"
    # The kernel library (ops/_lib.py), the reference's executable cache:
    # build it into cache_dir (default build/kernels/); copy it to
    # save_exe.so with a manifest; load load_exe.so in place of a build
    # while its digest matches the sources; compile_only builds the
    # library and the host runtime and exits before any render.
    cache_dir: str = ""
    save_exe: str = ""
    load_exe: str = ""
    compile_only: bool = False
    # The device mesh (parallel/mesh.py): ipus devices - the first CUDA
    # devices, or shards on the CPU with --device cpu - shaped
    # "PIXELSxSAMPLES" ("" = all on the pixel axis).  ipus > 1 or a
    # mesh_shape renders on the mesh; samples_per_step is split over its
    # sample axis.
    ipus: int = 1
    mesh_shape: str = ""
    # Test/smoke knob (no CLI flag): False renders with the trace and
    # env-shade kernels per sample instead of the megastep kernel.
    use_fused_step: bool = True

    def validate(self) -> None:
        if not self.assets:
            raise ValueError("the option '--assets' is required but missing")
        if self.samples_per_step < 1 or self.samples < 1:
            raise ValueError("samples and samples-per-step must be >= 1")
        if self.samples_per_step > 0xFFFF and not self.device_film:
            raise ValueError("samples-per-step > 65535 needs --device-film (the u16 "
                             "wire sampleCount would clip)")
        if self.interactive_samples > 0xFFFF and not self.device_film:
            raise ValueError("interactive-samples > 65535 needs --device-film (the u16 "
                             "wire sampleCount would clip)")
        if self.device_film and self.enable_load_balancing:
            raise ValueError("--device-film is incompatible with --enable-load-balancing "
                             "(load balancing needs per-step path lengths on the host)")
        if self.auto_resume and not self.checkpoint:
            raise ValueError("--auto-resume needs --checkpoint (the file it resumes from "
                             "and keeps writing)")
        if self.auto_resume and self.resume:
            raise ValueError("use either --resume or --auto-resume, not both")
        if self.save_interval < 1:
            raise ValueError("save-interval must be >= 1")
        if self.layout not in ("coherent", "raster"):
            raise ValueError(f"unknown --layout '{self.layout}' (choices: coherent, raster)")
        if self.env_skip not in ("auto", "on", "off"):
            raise ValueError(f"unknown --env-skip '{self.env_skip}' (choices: auto, on, off)")
        if self.partials_type not in ("half", "float"):
            raise ValueError(f"unknown --partials-type '{self.partials_type}' (choices: half, "
                             "float)")
        if self.save_exe and self.load_exe:
            raise ValueError("You can not set both save-exe and load-exe.")
        if self.nif_precision not in ("auto", "int8"):
            raise ValueError(f"unknown --nif-precision '{self.nif_precision}' (choices: auto, int8)")
        if self.nif_mode not in ("fused", "baked"):
            raise ValueError(f"unknown --nif-mode '{self.nif_mode}' (choices: fused, baked)")
        if self.max_nif_batch_size < 1:
            raise ValueError("max-nif-batch-size must be >= 1")
        if self.sampler not in ("prng", "sobol"):
            raise ValueError(f"unknown --sampler '{self.sampler}' (choices: prng, sobol)")
        if self.sampler == "sobol" and self.sobol_dims < 4:
            raise ValueError("--sobol-dims must be >= 4 (the camera dims)")
        if self.denoise_iters < 1 or self.denoise_iters > 8:
            raise ValueError("--denoise-iters must be in [1, 8] (filter radius grows as 2^n)")
        if self.denoise_sigma <= 0.0:
            raise ValueError("--denoise-sigma must be > 0")
        if self.denoise_clamp < 0.0:
            raise ValueError("--denoise-clamp must be >= 0 (0 disables)")
        from ..film.debugview import DEBUG_VIEWS

        if self.debug_view and self.debug_view not in DEBUG_VIEWS:
            raise ValueError(f"unknown --debug-view '{self.debug_view}' (choices: "
                             f"{', '.join(DEBUG_VIEWS)})")
        if self.adaptive:
            if not self.device_film:
                raise ValueError("--adaptive needs --device-film (int32 per-record "
                                 "counts and the on-device budget controller)")
            if self.nif_mode != "fused":
                raise ValueError("--adaptive needs --nif-mode fused (budgets live in "
                                 "the fused megastep)")
            if self.adaptive_min < 1:
                raise ValueError("--adaptive-min must be >= 1")
            if self.adaptive_max_factor < 1.0:
                raise ValueError("--adaptive-max-factor must be >= 1")
            if self.samples_per_step < self.adaptive_min or (
                    self.ui_port and self.interactive_samples < self.adaptive_min):
                raise ValueError("samples-per-step (and interactive-samples with a UI) "
                                 "must be >= --adaptive-min")
        if self.ipus > 1 or self.mesh_shape:
            from ..parallel.mesh import parse_mesh_shape

            _, sm = parse_mesh_shape(self.mesh_shape, self.ipus)
            if self.samples_per_step % sm or (self.ui_port and self.interactive_samples % sm):
                raise ValueError(f"samples-per-step (and interactive-samples with a UI) must "
                                 f"divide by the sample mesh axis ({sm})")
        if self.scene:
            from ..core.scenefile import load_scene

            load_scene(self.scene)  # a bad file fails here, before any render

    def rounded_samples_per_pixel(self) -> int:
        """Round spp up to a multiple of samples-per-step."""
        spp = self.samples
        if spp % self.samples_per_step:
            spp += self.samples_per_step - (spp % self.samples_per_step)
        return spp
