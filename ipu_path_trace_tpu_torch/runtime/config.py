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
    # The env-skip guard is not ported: "auto" resolves to off (and says
    # so), "on" raises (ROADMAP.md queue 1 item 11).
    env_skip: str = "auto"
    # "auto" runs the NIF as stored (bf16 chain); "int8" quantises it for
    # the int8 chain (models/quant.py), with a QAT asset's quant_amax.json.
    nif_precision: str = "auto"
    # "fused" evaluates the NIF per escaped ray; "baked" decodes it once
    # into an equirect texture (models/envlight.bake_nif_env) of the
    # asset's original_image_shape, in chunks of max_nif_batch_size.
    nif_mode: str = "fused"
    max_nif_batch_size: int = 30 * 1472
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
        if self.samples_per_step > 0xFFFF:
            raise ValueError("samples-per-step > 65535 would clip the u16 wire "
                             "sampleCount")
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

    def rounded_samples_per_pixel(self) -> int:
        """Round spp up to a multiple of samples-per-step."""
        spp = self.samples
        if spp % self.samples_per_step:
            spp += self.samples_per_step - (spp % self.samples_per_step)
        return spp
