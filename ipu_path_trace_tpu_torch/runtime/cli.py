"""The ``tpu_trace_torch`` command line.

The flags the port has keep the reference CLI's names and defaults
(``ipu_path_trace_tpu/runtime/cli.py``); ``--device`` is new.  The
reference flags with no CUDA counterpart are settled for good:
``--model`` is ``--device cpu``; ``--defer-attach``, ``--codelet-path``
and ``--available-memory-proportion`` are accepted and ignored (a debug
line says so); ``--no-use-pallas`` and any ``--rng-impl`` but ``auto``
are rejected; ``--compile-only``, ``--cache-dir``, ``--save-exe`` and
``--load-exe`` act on the kernel library (ops/_lib.py).  ``--ipus`` and
``--mesh-shape`` shard the render over a device mesh
(parallel/mesh.py): the first N GPUs, or with ``--device cpu`` N shards
on the CPU.  Every reference flag is ported or settled, so ``_UNPORTED``
is empty; a flag put there would be parsed and refused when set.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import signal
import sys

from ..utils.logging import handler as log_handler
from ..utils.logging import set_log_level
from .config import Config

log = logging.getLogger(__name__)

# Reference flags the port does not have yet: (flags, argparse kwargs, ROADMAP item).
_UNPORTED: list = []

# Reference flags accepted for parity and ignored: (flags, argparse kwargs, why).
_IGNORED = [
    (("--defer-attach",), dict(action="store_true"),
     "the CUDA context attaches at the first launch"),
    (("--codelet-path",), dict(default="./"),
     "the kernels are built from the package's csrc/, there are no codelets"),
    (("--available-memory-proportion",), dict(type=float, default=0.6),
     "each kernel plans its own shared memory"),
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
    p.add_argument("--interactive-samples", type=int, default=8,
                   help="Samples per step while the remote UI interacts (reverts to "
                        "--samples-per-step after a few quiet steps).")
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
                   help="The reference's skip of the NIF env-light chain for kernel "
                        "sub-tiles whose paths all died without escaping. Accepted and "
                        "without effect: the fused megastep shades escaping rays only "
                        "(its escape queue), so every setting renders the same image "
                        "with the same work.")
    p.add_argument("--scene", default="",
                   help="JSON scene description (spheres/discs with colour, emission, "
                        "material); default: the reference's built-in scene. See "
                        "core/scenefile.py for the schema.")
    p.add_argument("--enable-load-balancing", action="store_true", default=False,
                   help="Run the dynamic load balancing algorithm for path tracing (the "
                        "reference's shuffled worklist, re-dealt by path length every step; "
                        "overrides --layout).")
    p.add_argument("--checkpoint", default="",
                   help="Write the render's progressive state (.npz) at every save-interval "
                        "and at exit, so an interrupted render can be continued with "
                        "--resume (with --enable-load-balancing the re-deal layouts are "
                        "saved too, keeping resume bit for bit).")
    p.add_argument("--resume", default="",
                   help="Continue a render from a --checkpoint file; the result is bit for "
                        "bit the uninterrupted render's (the config must match the "
                        "checkpoint's fingerprint).")
    p.add_argument("--auto-resume", action="store_true", default=False,
                   help="With --checkpoint: resume from the checkpoint when it exists, "
                        "start afresh when it does not.")
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
    p.add_argument("--ui-port", type=int, default=0,
                   help="Serve the remote user interface on this TCP port: the render waits "
                        "for one client (ui/client.py), streams it previews and progress, "
                        "and takes its exposure, gamma, fov, env rotation, NIF and "
                        "interactive samples. 0 renders headless.")
    p.add_argument("--denoise", action="store_true", default=False,
                   help="Filter the saved images and the previews with the edge-avoiding "
                        "a-trous wavelet denoiser (primary-hit albedo/normal/depth guides, "
                        "film/denoise.py). The accumulator stays raw.")
    p.add_argument("--denoise-iters", type=int, default=4,
                   help="A-trous dilation passes for --denoise (filter radius 2^n pixels).")
    p.add_argument("--denoise-sigma", type=float, default=1.0,
                   help="Log-luminance edge-stop sigma for --denoise: lower keeps more "
                        "detail, higher smooths harder.")
    p.add_argument("--denoise-clamp", type=float, default=10.0,
                   help="Firefly suppressor for --denoise: clamp each pixel's luminance to "
                        "k x its 3x3 neighbourhood median before filtering (0 disables).")
    p.add_argument("--debug-view", default="",
                   choices=["", "normal", "albedo", "depth", "path-length", "escape-uv"],
                   help="Save a diagnostic channel instead of radiance (film/debugview.py), "
                        "rendered through the production camera and intersector. The "
                        "accumulator is untouched.")
    p.add_argument("--ipus", type=int, default=1, metavar="N",
                   help="Number of GPUs to shard the render over (with --device cpu: N shards "
                        "on the CPU).")
    p.add_argument("--mesh-shape", default="",
                   help="Device mesh as 'PIXELSxSAMPLES', e.g. '4x2'. Default: all devices on "
                        "the pixel axis. Given, it forces the mesh path even at --ipus 1.")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) runs the CUDA kernels; 'cpu' their plain versions.")
    p.add_argument("--model", action="store_true",
                   help="The reference's CPU simulator backend: the same as --device cpu "
                        "(with --device cuda it is an error).")
    p.add_argument("--partials-type", default="half", choices=["half", "float"],
                   help="NIF weight type: half -> the bf16 chain, float -> the f32 chain "
                        "(tf32 wgmma on the GPU).")
    p.add_argument("--use-pallas", action=argparse.BooleanOptionalAction, default=True,
                   help="Accepted for parity (the default). --no-use-pallas is rejected: "
                        "the port always runs its CUDA kernels on the GPU; --device cpu "
                        "runs their plain versions.")
    p.add_argument("--rng-impl", default="auto",
                   choices=["auto", "threefry2x32", "rbg", "unsafe_rbg"],
                   help="Accepted as 'auto' only: the other values pick a JAX key "
                        "implementation, and the port's streams are Philox in the kernels "
                        "and torch.Generator for host noise.")
    p.add_argument("--compile-only", action="store_true",
                   help="Build the kernel library and the host runtime from the sources, "
                        "print the library's path and exit (with --save-exe, save it first).")
    p.add_argument("--cache-dir", default="",
                   help="Directory of the built kernel library (default build/kernels/).")
    p.add_argument("--save-exe", default="", metavar="NAME",
                   help="Copy the built kernel library to NAME.so, with a NAME.json "
                        "manifest (source digest, nvcc flags, GPU name).")
    p.add_argument("--load-exe", default="", metavar="NAME",
                   help="Load the kernel library saved as NAME.so instead of building; "
                        "refused unless its manifest's digest is the sources'.")
    ignored = p.add_argument_group("Reference options accepted for parity and ignored")
    for flags, kwargs, why in _IGNORED:
        ignored.add_argument(*flags, **kwargs, help=f"Ignored: {why}.")
    unported = p.add_argument_group("Reference options not ported yet (non-defaults raise)")
    for flags, kwargs, _ in _UNPORTED:
        unported.add_argument(*flags, **kwargs, help=argparse.SUPPRESS)
    return p


def ignored_flags(argv=None) -> list[tuple[str, str]]:
    """The accepted-and-ignored flags that ``argv`` sets: (flag, why)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    return [(flags[0], why) for flags, _, why in _IGNORED
            if getattr(args, _dest(flags[0])) != parser.get_default(_dest(flags[0]))]


def parse_config(argv=None) -> Config:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flags, _, item in _UNPORTED:
        dest = _dest(flags[0])
        if getattr(args, dest) != parser.get_default(dest):
            raise NotImplementedError(
                f"{flags[0]} is not ported to the PyTorch/CUDA renderer yet "
                f"(ROADMAP.md {item})")
    if not args.use_pallas:
        raise ValueError("--no-use-pallas is not supported: the port runs its CUDA kernels on "
                         "the GPU and never a plain version there; --device cpu runs the "
                         "plain versions")
    if args.rng_impl != "auto":
        raise ValueError(f"--rng-impl {args.rng_impl} picks a JAX PRNG key implementation; "
                         "the port's streams are Philox (kernels) and torch.Generator (host "
                         "noise), so only 'auto' is accepted")
    if args.model:
        if args.device not in (None, "cpu"):
            raise ValueError("--model is the reference's CPU simulator backend (--device "
                             f"cpu); it cannot run with --device {args.device}")
        args.device = "cpu"
    args.device = args.device or "cuda"
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
    for flag, why in ignored_flags(argv):
        log.debug("%s is accepted for parity and ignored: %s", flag, why)
    from ..ops import _lib

    try:
        _lib.configure(cfg.cache_dir, cfg.load_exe)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if cfg.compile_only or cfg.save_exe:
        prepare_kernels(cfg)
        if cfg.compile_only:
            return 0
    from .app import PathTracerApp

    app = PathTracerApp(cfg)
    app.init()
    app.build()
    ui_server = None
    if cfg.ui_port:
        ui_server = start_ui_server(cfg)
    try:
        with graceful_stop(app):
            app.execute(ui_server=ui_server)
    finally:
        if ui_server is not None:
            ui_server.stop()
    return 0


def prepare_kernels(cfg: Config):
    """``--compile-only`` and ``--save-exe``: build the kernel library (or
    take the ``--load-exe`` one) and the host runtime now; save the
    library under ``--save-exe``; print the library's path.  Without nvcc
    (or g++) the build raises."""
    from ..ops import _lib
    from . import native

    lib = _lib.library_path()
    native.library()
    if cfg.save_exe:
        saved = _lib.save_exe(cfg.save_exe)
        log.info("Saved the kernel library to '%s' (manifest %s)", saved,
                 saved.with_suffix(".json"))
    print(lib)
    log.info("Kernel library: %s; host runtime: %s", lib, native.build())
    return lib


def start_ui_server(cfg: Config):
    """Serve the remote UI on ``cfg.ui_port`` and block until one client
    connects; a failed bind (the port taken) raises at once.  The
    preview stream is set up at the render's size."""
    from ..ui.server import InterfaceServer

    server = InterfaceServer(cfg.ui_port)
    server.start()
    log.info("Waiting for remote UI client to connect...")
    if not server.wait_for_client():
        server.stop()
        raise RuntimeError(f"UI server failed to accept a client on port {cfg.ui_port} "
                           "(port in use?)")
    server.initialise_video_stream(cfg.width, cfg.height)
    return server


@contextlib.contextmanager
def graceful_stop(app):
    """The first SIGTERM or SIGINT sets ``app.stop_requested``: the loop
    finishes its step and takes the exit path (the final fetch, the
    checkpoint, the save).  The handler then restores the previous ones,
    so a second signal acts as it would have without it."""
    prev = {}

    def handler(signum, frame):
        log.info("Received signal %d; finishing the current step and saving "
                 "(send it again to stop at once)", signum)
        app.stop_requested = True
        for s, h in prev.items():
            signal.signal(s, h)

    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[s] = signal.signal(s, handler)
        except ValueError:  # not the main thread: no handler
            pass
    try:
        yield
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


if __name__ == "__main__":
    sys.exit(main())
