"""Build and bind the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use
nvcc compiles each of them for sm_90a, all at once in parallel processes,
and links the objects into one shared library under ``build/kernels/`` at
the root of the checkout (named by a hash of the sources and flags, so an
edit rebuilds), which is loaded with ctypes.  Nothing here runs at import
time: the CPU tests import every module of the port on machines without
nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
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


def build_dir() -> Path:
    """``build/kernels`` beside the package (listed in .gitignore)."""
    return CSRC.parent.parent / "build" / "kernels"


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


class NifNet(ctypes.Structure):
    """csrc/nif_dev.cuh::NifNet."""

    _fields_ = [
        ("num_layers", ctypes.c_int), ("embed_dim", ctypes.c_int),
        ("max_width", ctypes.c_int), ("log_flag", ctypes.c_int), ("int8", ctypes.c_int),
        ("fan_in", ctypes.c_int * NIF_MAX_LAYERS),
        ("fan_out", ctypes.c_int * NIF_MAX_LAYERS),
        ("skip", ctypes.c_int * NIF_MAX_LAYERS),
        ("k_trunk", ctypes.c_int * NIF_MAX_LAYERS),
        ("k_pad", ctypes.c_int * NIF_MAX_LAYERS),
        ("w", ctypes.c_void_p * NIF_MAX_LAYERS),
        ("b", ctypes.c_void_p * NIF_MAX_LAYERS),
        ("mult", ctypes.c_void_p * NIF_MAX_LAYERS),
        ("mult_skip", ctypes.c_void_p),
        ("inv_next", ctypes.c_float * NIF_MAX_LAYERS),
        ("max_v", ctypes.c_float), ("mean", ctypes.c_float * 3),
    ]


class NifWg(ctypes.Structure):
    """csrc/nif_wgmma.cuh::NifWg."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "num_layers", "embed_dim", "log_flag", "stages", "stage_bytes", "feat_atoms",
            "smem_feat", "smem_ring", "smem_bar", "smem_uv", "smem_bytes")]
        + [(n, ctypes.c_int * NIF_MAX_LAYERS) for n in (
            "chunks", "in_atoms", "f_atoms", "slice_bytes")]
        + [("w", ctypes.c_void_p * NIF_MAX_LAYERS), ("b", ctypes.c_void_p * NIF_MAX_LAYERS),
           ("max_v", ctypes.c_float), ("mean", ctypes.c_float * 3)]
    )


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; declares every signature."""
    lib = ctypes.CDLL(str(build()))
    lib.pt_trace.argtypes = [ctypes.POINTER(TraceParams), _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _P, _P, _P, _P, _P, _P]
    # K2 and K4 take an int8 model's NifNet or a bf16 model's NifWg (the other None).
    lib.pt_env_shade.argtypes = [ctypes.POINTER(NifNet), ctypes.POINTER(NifWg), _P, _P,
                                 ctypes.c_float, _I, _P, _P]
    lib.pt_nif_apply.argtypes = [ctypes.POINTER(NifNet), ctypes.POINTER(NifWg), _P, _P, _I, _P,
                                 _P]
    # K3 likewise: an int8 model's NifNet or a bf16 model's NifWg (K3's plan).
    lib.pt_megastep.argtypes = [ctypes.POINTER(TraceParams), ctypes.POINTER(NifNet),
                                ctypes.POINTER(NifWg), _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _P, _P, _P, _P]
    lib.pt_megastep_stub.argtypes = [ctypes.POINTER(TraceParams), ctypes.POINTER(NifNet),
                                     ctypes.POINTER(NifWg), _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _P, _P, _P, _I, _P]
    lib.pt_probe_mxu.argtypes = [ctypes.POINTER(NifNet), _P, _I, _P, _P]
    lib.pt_probe_alu.argtypes = [_P, _I, _I, _P, _P]
    lib.pt_probe_both.argtypes = [ctypes.POINTER(NifNet), _P, _I, _I, _P, _P]
    lib.pt_probe_loop.argtypes = [ctypes.POINTER(NifNet), _P, _I, _I, _I, _I, _I, _P, _P]
    lib.pt_quant_probe.argtypes = [ctypes.POINTER(NifNet), _I, _P, _I, _P, _P]
    lib.pt_error_string.argtypes = [_I]
    lib.pt_error_string.restype = ctypes.c_char_p
    for fn in (lib.pt_trace, lib.pt_env_shade, lib.pt_nif_apply, lib.pt_megastep,
               lib.pt_megastep_stub, lib.pt_probe_mxu, lib.pt_probe_alu, lib.pt_probe_both,
               lib.pt_probe_loop, lib.pt_quant_probe):
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
