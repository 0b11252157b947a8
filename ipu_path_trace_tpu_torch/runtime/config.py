"""Application configuration of the port's headless renderer.

Counterpart of ``ipu_path_trace_tpu/runtime/config.py`` for the flags
the port has: the same names and defaults, plus ``device``.  The
reference's other flags are listed in runtime/cli.py with the ROADMAP
item that will port each.
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
    # Dead-block env-skip: the megastep skips the NIF chain for sub-tiles
    # whose escape weights are all zero (exact).  "auto" measures the
    # fraction of such sub-tiles with a two-sample probe over the real
    # worklist and turns the skip on at >= 2% (runtime/app.py
    # PathTracerApp.resolve_env_skip); "on"/"off" force it.
    env_skip: str = "auto"
    # "auto" runs the NIF as stored (bf16 chain); "int8" quantises it for
    # the int8 chain (models/quant.py), with a QAT asset's quant_amax.json.
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
    # Where the render runs.  "cuda" launches the kernels; "cpu" runs
    # their plain versions (the port's simulator).  A CUDA request on a
    # machine without CUDA raises: nothing falls back to the CPU.
    device: str = "cuda"
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
        if self.save_interval < 1:
            raise ValueError("save-interval must be >= 1")
        if self.layout not in ("coherent", "raster"):
            raise ValueError(f"unknown --layout '{self.layout}' (choices: coherent, raster)")
        if self.env_skip not in ("auto", "on", "off"):
            raise ValueError(f"unknown --env-skip '{self.env_skip}' (choices: auto, on, off)")
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
            if self.samples_per_step < self.adaptive_min:
                raise ValueError("samples-per-step must be >= --adaptive-min")
        if self.scene:
            from ..core.scenefile import load_scene

            load_scene(self.scene)  # a bad file fails here, before any render

    def rounded_samples_per_pixel(self) -> int:
        """Round spp up to a multiple of samples-per-step."""
        spp = self.samples
        if spp % self.samples_per_step:
            spp += self.samples_per_step - (spp % self.samples_per_step)
        return spp
