"""Build and bind the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use
nvcc compiles each of them for sm_90a, all at once in parallel processes,
and links the objects into one shared library under ``build/kernels/`` at
the root of the checkout (named by a hash of the sources and flags, so an
edit rebuilds), which is loaded with ctypes.  Nothing here runs at import
time: the CPU tests import every module of the port on machines without
nvcc or a GPU.

The CLI's ``--cache-dir``, ``--save-exe`` and ``--load-exe`` (the
reference's compilation cache and saved executables) act on that library
(``configure``, ``save_exe``): another build directory; a copy of the
built library as ``NAME.so`` with a ``NAME.json`` manifest (the source
digest, the nvcc flags, the GPU's name); and a saved library loaded in
place of a build, only while its digest is today's sources'.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("trace.cu", "nif.cu", "megastep.cu", "megastep_stub.cu", "probes.cu",
           "quant_probe.cu")
HEADERS = ("common.cuh", "nif_dev.cuh", "nif_wgmma.cuh", "sobol_dirs.cuh", "megastep.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # No contraction of a * b + c into one FMA: every product and sum of
    # the trace rounds where PyTorch's eager ops round, so the trace
    # replays its plain version instead of diverging on tangent rays and
    # Fresnel choices.  The NIF chain's products run on the tensor cores.
    "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers and spills go to the build log
)
NIF_MAX_LAYERS = 16  # csrc/nif_dev.cuh kNifMaxLayers


# --cache-dir and --load-exe (``configure``): None keeps the defaults.
_OVERRIDES: dict[str, Path | None] = {"build_dir": None, "load_exe": None}


def build_dir() -> Path:
    """``build/kernels`` beside the package (listed in .gitignore), or the
    ``--cache-dir`` given to ``configure``."""
    return _OVERRIDES["build_dir"] or CSRC.parent.parent / "build" / "kernels"


def _exe_paths(name: str) -> tuple[Path, Path]:
    return Path(name + ".so"), Path(name + ".json")


def check_exe(name: str) -> Path:
    """``NAME.so`` when ``NAME.json`` records today's source digest;
    otherwise ValueError (a saved library of other sources is never
    loaded, and nothing rebuilds in its place)."""
    lib, manifest = _exe_paths(name)
    try:
        saved = json.loads(manifest.read_text())
    except (OSError, ValueError) as e:
        raise ValueError(f"--load-exe {name}: no readable manifest {manifest} ({e})") from e
    if saved.get("digest") != _digest():
        raise ValueError(f"--load-exe {name}: saved for source digest {saved.get('digest')}, "
                         f"but the sources are {_digest()}; rebuild it with --save-exe")
    if not lib.is_file():
        raise ValueError(f"--load-exe {name}: {lib} is missing")
    return lib


def configure(cache_dir: str = "", load_exe: str = "") -> None:
    """``--cache-dir``: build the library there; ``--load-exe``: load the
    saved ``NAME.so`` (``check_exe``) instead of building.  Before the
    library is first loaded; a change after that raises."""
    want = {"build_dir": Path(cache_dir) if cache_dir else None,
            "load_exe": check_exe(load_exe) if load_exe else None}
    if want != _OVERRIDES and library.cache_info().currsize:
        raise RuntimeError("the kernel library is already loaded; --cache-dir and "
                           "--load-exe must be set before the first launch")
    _OVERRIDES.update(want)


def library_path() -> Path:
    """The library ``library()`` loads: the saved one of ``--load-exe``, or
    this checkout's build (built now if it is not there yet)."""
    return _OVERRIDES["load_exe"] or build()


def save_exe(name: str) -> Path:
    """``--save-exe NAME``: the built (or loaded) library copied to
    ``NAME.so`` beside a ``NAME.json`` manifest of the source digest, the
    nvcc flags and the GPU's name (None without one)."""
    src = library_path()
    lib, manifest = _exe_paths(name)
    lib.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src, lib)
    gpu = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
    manifest.write_text(json.dumps({"digest": _digest(), "nvcc_flags": list(NVCC_FLAGS),
                                    "gpu": gpu, "library": lib.name}, indent=1) + "\n")
    return lib


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built at "
                       "first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (once per source digest); returns the library."""
    out = build_dir() / f"libpt_kernels_{_digest()}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [out.with_name(f"{tag}.{Path(src).stem}.o") for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [src for src, proc in zip(SOURCES, procs) if proc.returncode]
    tmp = out.with_name(f"{tag}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        failed = ["link"] if link.returncode else []
    out.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{''.join(logs)[-4000:]}")
    os.replace(tmp, out)
    return out


class TraceParams(ctypes.Structure):
    """csrc/common.cuh::TraceParams."""

    _fields_ = (
        [(n, ctypes.c_float) for n in (
            "tanfov_x", "tanfov_y", "aa_scale", "refr_index", "stop_prob",
            "aperture", "focal", "azimuth")]
        + [(n, ctypes.c_int) for n in (
            "width", "height", "max_path_length", "roulette_depth", "aa_type",
            "num_s", "num_d", "sobol_dims")]
        + [(n, ctypes.c_uint32) for n in ("seed0", "seed1", "sobol_key", "pad0")]
    )


class NifWg(ctypes.Structure):
    """csrc/nif_wgmma.cuh::NifWg."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "num_layers", "embed_dim", "log_flag", "stages", "stage_bytes", "feat_atoms",
            "smem_feat", "smem_ring", "smem_bar", "smem_uv", "smem_bytes")]
        + [(n, ctypes.c_int * NIF_MAX_LAYERS) for n in (
            "chunks", "in_atoms", "f_atoms", "slice_bytes")]
        + [("w", ctypes.c_void_p * NIF_MAX_LAYERS), ("b", ctypes.c_void_p * NIF_MAX_LAYERS),
           ("max_v", ctypes.c_float), ("mean", ctypes.c_float * 3),
           # the 8-bit chains
           ("int8", ctypes.c_int), ("smem_codes", ctypes.c_int),
           ("passes", ctypes.c_int * NIF_MAX_LAYERS),
           ("inv_next", ctypes.c_float * NIF_MAX_LAYERS),
           ("mult", ctypes.c_void_p * NIF_MAX_LAYERS), ("mult_skip", ctypes.c_void_p),
           # the f32 chain on tf32 wgmma
           ("tf32", ctypes.c_int), ("w_lo", ctypes.c_void_p * NIF_MAX_LAYERS)]
    )


class MegaArgs(ctypes.Structure):
    """csrc/megastep.cuh::MegaArgs, K3's launch arguments past the
    TraceParams and the NifWg."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "sph", "dsc", "cols", "rows", "noise", "pid", "base", "budgets", "order", "ticket")]
        + [(n, ctypes.c_int) for n in ("budget_block", "samples", "n")]
        + [(n, ctypes.c_void_p) for n in ("rad", "plen", "lum2", "stamps")]
    )


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels - or the saved library of
    ``--load-exe`` - and declare every signature."""
    lib = ctypes.CDLL(str(library_path()))
    lib.pt_trace.argtypes = [ctypes.POINTER(TraceParams), _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P]
    # K2, K3, K4, K6, K7 and K8 take a NifWg (bf16, 8-bit or tf32 by its flags; K3's plan for K3).
    wg = ctypes.POINTER(NifWg)
    lib.pt_env_shade.argtypes = [wg, _P, _P, ctypes.c_float, _I, _P, _P]
    lib.pt_nif_apply.argtypes = [wg, _P, _P, _I, _P, _P]
    lib.pt_megastep.argtypes = [ctypes.POINTER(TraceParams), wg, ctypes.POINTER(MegaArgs), _I,
                                _P]
    lib.pt_probe_mxu.argtypes = [wg, _P, _I, _P, _P]
    lib.pt_probe_alu.argtypes = [_P, _I, _I, _P, _P]
    lib.pt_probe_both.argtypes = [wg, _P, _I, _I, _P, _P]
    lib.pt_probe_loop.argtypes = [wg, _P, _I, _I, _I, _I, _I, _P, _P]
    lib.pt_quant_probe.argtypes = [wg, _I, _P, _I, _I, _P, _P]
    lib.pt_error_string.argtypes = [_I]
    lib.pt_error_string.restype = ctypes.c_char_p
    for fn in (lib.pt_trace, lib.pt_env_shade, lib.pt_nif_apply, lib.pt_megastep,
               lib.pt_probe_mxu, lib.pt_probe_alu, lib.pt_probe_both, lib.pt_probe_loop,
               lib.pt_quant_probe):
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err:
        msg = library().pt_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """Validate the operands of a kernel launch: one CUDA device, contiguous."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev} (the kernel needs CUDA)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operand of shape {tuple(t.shape)} is not contiguous")
    return dev
