"""The ``tpu_trace_torch`` command line.

The flags the port has keep the reference CLI's names and defaults
(``ipu_path_trace_tpu/runtime/cli.py``); ``--device`` is new.  Every
other reference flag is still accepted by the parser, so that setting
it to anything but its default fails with the ROADMAP.md item that will
port it instead of being silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

from ..utils.logging import handler as log_handler
from ..utils.logging import set_log_level
from .config import Config

# Reference flags the port does not have yet: (flags, argparse kwargs, ROADMAP item).
_UNPORTED = [
    (("--model",), dict(action="store_true"), "queue 1 item 20 (use --device cpu)"),
    (("--ipus",), dict(type=int, default=1), "queue 1 item 15 (multi-GPU)"),
    (("--save-exe",), dict(default=""), "queue 1 item 19"),
    (("--load-exe",), dict(default=""), "queue 1 item 19"),
    (("--compile-only",), dict(action="store_true"), "queue 1 item 19"),
    (("--defer-attach",), dict(action="store_true"), "queue 1 item 20"),
    (("--interactive-samples",), dict(type=int, default=8), "queue 1 item 17 (ui)"),
    (("--codelet-path",), dict(default="./"), "queue 1 item 20"),
    (("--enable-load-balancing",), dict(action="store_true"), "queue 1 item 20"),
    (("--partials-type",), dict(default="half", choices=["half", "float"]),
     "queue 1 item 20 (f32 NIF chain in the kernels)"),
    (("--available-memory-proportion",), dict(type=float, default=0.6), "queue 1 item 20"),
    (("--ui-port",), dict(type=int, default=0), "queue 1 item 17 (ui)"),
    (("--use-pallas",), dict(action=argparse.BooleanOptionalAction, default=True),
     "queue 1 item 20 (the port always runs its kernels)"),
    (("--mesh-shape",), dict(default=""), "queue 1 item 15 (multi-GPU)"),
    (("--cache-dir",), dict(default=""), "queue 1 item 19"),
    (("--checkpoint",), dict(default=""), "queue 1 item 12"),
    (("--resume",), dict(default=""), "queue 1 item 12"),
    (("--auto-resume",), dict(action="store_true"), "queue 1 item 12"),
    (("--rng-impl",), dict(default="auto", choices=[
        "auto", "threefry2x32", "rbg", "unsafe_rbg"]),
     "queue 1 item 20 (the port's kernels use Philox)"),
    (("--denoise",), dict(action="store_true"), "queue 1 item 13"),
    (("--denoise-iters",), dict(type=int, default=4), "queue 1 item 13"),
    (("--denoise-sigma",), dict(type=float, default=1.0), "queue 1 item 13"),
    (("--denoise-clamp",), dict(type=float, default=10.0), "queue 1 item 13"),
    (("--debug-view",), dict(default=""), "queue 1 item 13"),
]


def _dest(flag: str) -> str:
    return flag.lstrip("-").replace("-", "_")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_trace_torch",
        description="PyTorch/CUDA port of the neural path tracer (hand-written "
                    "CUDA kernels on the GPU, their plain versions on the CPU).",
        add_help=False,
    )
    p.add_argument("--help", action="help", help="Show command help.")
    p.add_argument("--outfile", "-o", required=True, help="Set output file name.")
    p.add_argument("--save-interval", type=int, default=1)
    p.add_argument("--width", "-w", type=int, default=256, help="Output image width.")
    p.add_argument("--height", "-H", type=int, default=256, help="Output image height.")
    p.add_argument("--samples", "-s", type=int, default=512, help="Total samples per pixel.")
    p.add_argument("--samples-per-step", type=int, default=512, help="Samples per step.")
    p.add_argument("--refractive-index", "-n", type=float, default=1.5)
    p.add_argument("--roulette-depth", type=int, default=3,
                   help="Number of bounces before rays are randomly stopped.")
    p.add_argument("--stop-prob", type=float, default=0.3,
                   help="Probability of a ray being stopped.")
    p.add_argument("--aa-noise-scale", "-a", type=float, default=0.3,
                   help="Scale of anti-aliasing noise (pixels).")
    p.add_argument("--fov", type=float, default=90.0, help="Horizontal field of view (degrees).")
    p.add_argument("--exposure", type=float, default=0.0)
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--env-map-rotation", type=float, default=0.0,
                   help="Azimuthal rotation of the environment (degrees).")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--aa-noise-type", default="normal",
                   choices=["uniform", "normal", "truncated-normal"])
    p.add_argument("--max-path-length", type=int, default=10)
    p.add_argument("--assets", required=True,
                   help="NIF assets directory, 'constant:R,G,B' or 'texture:<file.exr>'.")
    p.add_argument("--max-nif-batch-size", type=int, default=30 * 1472,
                   help="NIF evaluations per launch when baking (--nif-mode baked).")
    p.add_argument("--nif-mode", default="fused", choices=["fused", "baked"],
                   help="'fused' evaluates the NIF per escaped ray; 'baked' decodes it once "
                        "into an equirect texture and looks escaped rays up bilinearly.")
    p.add_argument("--nif-precision", default="auto", choices=["auto", "int8"],
                   help="'int8' quantises the NIF for the int8 chain (a QAT asset's "
                        "quant_amax.json sets the activation grids).")
    p.add_argument("--aperture", type=float, default=0.0,
                   help="Thin-lens aperture radius; 0 = pinhole.")
    p.add_argument("--focal-distance", type=float, default=1.0)
    p.add_argument("--layout", default="coherent", choices=["coherent", "raster"],
                   help="Worklist order: primary-hit-sorted or row-major.")
    p.add_argument("--env-skip", nargs="?", const="on", default="auto",
                   choices=("auto", "on", "off"),
                   help="Skip the NIF env-light chain for kernel sub-tiles whose paths "
                        "all died without escaping (exact). 'auto' (default) probes the "
                        "scene's dead sub-tile fraction at build time and enables the "
                        "skip only when it clears the guard cost; a bare --env-skip "
                        "forces it on, '--env-skip off' forces it off.")
    p.add_argument("--scene", default="",
                   help="JSON scene description (spheres/discs with colour, emission, "
                        "material); default: the reference's built-in scene. See "
                        "core/scenefile.py for the schema.")
    p.add_argument("--device-film", action="store_true", default=False,
                   help="Keep the worklist device-resident between steps and download "
                        "results only at save-interval boundaries (the host film "
                        "round-trips the trace buffer every step).")
    p.add_argument("--adaptive", action="store_true", default=False,
                   help="Adaptive per-block sampling: allocate each step's sample "
                        "budget across kernel blocks by measured luminance variance "
                        "(Neyman allocation) instead of uniformly. Unbiased (the film "
                        "normalises per record) and deterministic. Needs --device-film "
                        "and a NIF environment.")
    p.add_argument("--adaptive-min", type=int, default=8,
                   help="Adaptive sampling: per-block budget floor (samples per step).")
    p.add_argument("--adaptive-max-factor", type=float, default=16.0,
                   help="Adaptive sampling: per-block budget cap as a multiple of "
                        "--samples-per-step.")
    p.add_argument("--sampler", default="prng", choices=["prng", "sobol"],
                   help="Sample-stream generator: prng = independent uniforms "
                        "(reference behaviour); sobol = hash-based Owen-scrambled Sobol "
                        "on the leading path dimensions - the same unbiased estimator "
                        "with faster RMSE convergence per sample.")
    p.add_argument("--sobol-dims", type=int, default=12,
                   help="With --sampler sobol: how many leading path dimensions ride "
                        "the Sobol sequence (camera 4 + 4 per bounce; rounded down to "
                        "whole bounces, prng beyond).")
    p.add_argument("--log-level", default="info",
                   choices=["trace", "debug", "info", "warn", "err", "critical", "off"],
                   help="Set the log level.")
    p.add_argument("--profile-dir", default="",
                   help="Write a torch.profiler trace of the render loop here "
                        "(<dir>/trace.json, Chrome's trace format; the PVTI analog).")
    p.add_argument("--device-timing", action="store_true", default=False,
                   help="Measure and log the per-sample device-time split (env, trace and "
                        "overhead of the fused step; the trace and env-shade kernels when "
                        "unfused) at the render shape before the loop starts - the "
                        "cycle-counter analog of the reference.")
    p.add_argument("--metrics-file", default="",
                   help="Append one JSON line per completed render step (step, seconds, "
                        "samples_per_sec, spp) plus a final summary.")
    p.add_argument("--device", default="cuda",
                   help="'cuda' runs the CUDA kernels; 'cpu' their plain versions.")
    unported = p.add_argument_group("Reference options not ported yet (non-defaults raise)")
    for flags, kwargs, _ in _UNPORTED:
        unported.add_argument(*flags, **kwargs, help=argparse.SUPPRESS)
    return p


def parse_config(argv=None) -> Config:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flags, _, item in _UNPORTED:
        dest = _dest(flags[0])
        if getattr(args, dest) != parser.get_default(dest):
            raise NotImplementedError(
                f"{flags[0]} is not ported to the PyTorch/CUDA renderer yet "
                f"(ROADMAP.md {item})")
    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in vars(args).items() if k in fields})
    cfg.validate()
    return cfg


def main(argv=None, *, use_fused_step: bool | None = None) -> int:
    """Parse, build and render.  ``use_fused_step`` (no flag, as in the
    reference) picks the megastep kernel or trace + env shade per sample."""
    try:
        cfg = parse_config(argv)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if use_fused_step is not None:
        cfg = dataclasses.replace(cfg, use_fused_step=use_fused_step)
    logging.basicConfig(level=logging.INFO, handlers=[log_handler()])
    set_log_level(cfg.log_level)
    from .app import PathTracerApp

    app = PathTracerApp(cfg)
    app.init()
    app.build()
    app.execute()
    return 0


if __name__ == "__main__":
    sys.exit(main())
