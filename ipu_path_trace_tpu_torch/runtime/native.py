"""ctypes bindings of the native host runtime (``csrc/pt_host.cpp``,
``csrc/pt_jpeg.cpp``).

Counterpart of ``ipu_path_trace_tpu/runtime/native.py``: the film's
accumulation (records and SoA), the tone map, the fused clear and
path-length sum, and the load balancer's re-deal, in C++ with OpenMP;
and the preview stream's JPEG scan (ui/jpeg.py), which the JAX package
leaves to PIL.

At first use g++ builds the sources into one library in ``build/host/`` at
the root of the checkout (listed in .gitignore), named by a hash of the
sources, the compiler and its flags, so an edit rebuilds.  ``-ffp-contract=off`` keeps
every product and sum rounding where NumPy rounds it, so the native film
equals its plain version (film/film.py) bit for bit.  A build or load
failure raises with the compiler's output: nothing falls back to NumPy
behind the caller's back.  The plain versions run only where a caller
asks for them (``Film(..., native=False)``, the tests).

Each entry point counts its calls (``accumulate.calls`` ...), as the
kernels count their launches, so a run can show which route it took.
ctypes releases the interpreter lock for the call, so the host task's
native work overlaps the main thread's waits on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..core.records import TRACE_RECORD_DTYPE

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("pt_host.cpp", "pt_jpeg.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-fopenmp", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")

_lock = threading.Lock()


def build_dir() -> Path:
    """``build/host`` beside the package (listed in .gitignore)."""
    return CSRC.parent.parent / "build" / "host"


def _digest(cxx: str) -> str:
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS)).encode())
    for src in SOURCES:
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()[:16]


def build(cxx: str | None = None, out_dir: Path | None = None) -> Path:
    """Compile the host runtime (once per digest); returns the library.
    Raises RuntimeError with the compiler's output if it fails."""
    cxx = cxx or CXX
    out = (out_dir or build_dir()) / f"libpt_host_{_digest(cxx)}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(CSRC / src) for src in SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run {cxx!r} to build the host runtime "
                           f"({' '.join(cmd)}): {e}") from e
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {res.returncode}):\n"
                           f"{(res.stdout + res.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    u8p, i32p, f32p = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_int32,
                                                    ctypes.c_float))
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.pt_accumulate.argtypes = [u8p, i64, f32p, i32, i32]
    lib.pt_accumulate_soa.argtypes = [i32p, i32p, f32p, f32p, f32p, i32p, i64, f32p, i32, i32]
    lib.pt_tonemap.argtypes = [f32p, u8p, i64, ctypes.c_float, ctypes.c_float]
    lib.pt_clear_and_sum_pathlengths.argtypes = [u8p, i64]
    lib.pt_load_balance.argtypes = [u8p, i64, i64]
    lib.pt_jpeg_scan.argtypes = [u8p, i32, i32, i32p, ctypes.POINTER(ctypes.c_uint32), u8p,
                                 u8p, i64]
    lib.pt_jpeg_scan.restype = i64
    for fn in (lib.pt_accumulate, lib.pt_accumulate_soa, lib.pt_tonemap, lib.pt_load_balance):
        fn.restype = None
    lib.pt_clear_and_sum_pathlengths.restype = ctypes.c_uint64
    return lib


def library() -> ctypes.CDLL:
    """Build (if needed) and load the host runtime; declares every signature."""
    with _lock:
        return _library()


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _records(records: np.ndarray) -> np.ndarray:
    """The records as the C++ side reads them, in place: 20-byte
    TraceRecords, C-contiguous and writable."""
    if records.dtype != TRACE_RECORD_DTYPE:
        raise TypeError(f"expected TRACE_RECORD_DTYPE records, got {records.dtype}")
    if not (records.flags["C_CONTIGUOUS"] and records.flags["WRITEABLE"]):
        raise ValueError("records must be a C-contiguous, writable array")
    return records


def _film(hdr: np.ndarray) -> np.ndarray:
    if not (hdr.dtype == np.float32 and hdr.ndim == 3 and hdr.shape[2] == 3
            and hdr.flags["C_CONTIGUOUS"]):
        raise ValueError("the film must be a C-contiguous float32 (H, W, 3) array")
    return hdr


def accumulate(records: np.ndarray, hdr: np.ndarray) -> None:
    """hdr[v, u] += rgb / sampleCount for each record in the image."""
    lib = library()
    rec = np.ascontiguousarray(records)
    if rec.dtype != TRACE_RECORD_DTYPE:
        raise TypeError(f"expected TRACE_RECORD_DTYPE records, got {rec.dtype}")
    hdr = _film(hdr)
    lib.pt_accumulate(_p(rec, ctypes.c_uint8), len(rec), _p(hdr, ctypes.c_float),
                      hdr.shape[1], hdr.shape[0])
    accumulate.calls += 1


accumulate.calls = 0


def accumulate_soa(u, v, r, g, b, sample_count, hdr: np.ndarray) -> None:
    """accumulate() from SoA arrays with int32 counts."""
    lib = library()
    u, v, cnt = (np.ascontiguousarray(a, np.int32) for a in (u, v, sample_count))
    r, g, b = (np.ascontiguousarray(a, np.float32) for a in (r, g, b))
    lengths = {len(a) for a in (u, v, r, g, b, cnt)}
    if len(lengths) != 1:  # the C++ side reads len(u) of each
        raise ValueError(f"accumulate_soa: arrays of lengths {sorted(lengths)}")
    hdr = _film(hdr)
    i32 = ctypes.c_int32
    lib.pt_accumulate_soa(_p(u, i32), _p(v, i32), _p(r, ctypes.c_float), _p(g, ctypes.c_float),
                          _p(b, ctypes.c_float), _p(cnt, i32), len(u), _p(hdr, ctypes.c_float),
                          hdr.shape[1], hdr.shape[0])
    accumulate_soa.calls += 1


accumulate_soa.calls = 0


def tonemap(scaled: np.ndarray, exposure: float, gamma: float) -> np.ndarray:
    """(scaled * 2^exposure)^(1/gamma) -> uint8, rounding half up."""
    lib = library()
    src = np.ascontiguousarray(scaled, np.float32)
    out = np.empty(src.shape, np.uint8)
    lib.pt_tonemap(_p(src, ctypes.c_float), _p(out, ctypes.c_uint8), src.size, exposure, gamma)
    tonemap.calls += 1
    return out


tonemap.calls = 0


def clear_and_sum_pathlengths(records: np.ndarray) -> int:
    """Zero the accumulators in place; returns the path-length sum."""
    lib = library()
    rec = _records(records)
    total = int(lib.pt_clear_and_sum_pathlengths(_p(rec, ctypes.c_uint8), len(rec)))
    clear_and_sum_pathlengths.calls += 1
    return total


clear_and_sum_pathlengths.calls = 0


def load_balance(records: np.ndarray, num_tiles: int) -> None:
    """Re-deal the records in place: (shortest, longest) pairs per tile."""
    lib = library()
    rec = _records(records)
    lib.pt_load_balance(_p(rec, ctypes.c_uint8), len(rec), num_tiles)
    load_balance.calls += 1


load_balance.calls = 0

def jpeg_scan(rgb: np.ndarray, qtables: np.ndarray, codes: np.ndarray,
              sizes: np.ndarray) -> bytes:
    """The entropy-coded 4:2:0 scan of (H, W, 3) uint8 ``rgb`` with the
    (2, 64) quantisers and the (4, 256) Huffman codes and lengths of
    ui/jpeg.py, byte for byte its ``encode_scan_plain``."""
    lib = library()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    qt = np.ascontiguousarray(qtables, np.int32)
    codes = np.ascontiguousarray(codes, np.uint32)
    sizes = np.ascontiguousarray(sizes, np.uint8)
    if rgb.shape != (h, w, 3) or qt.shape != (2, 64) or codes.shape != (4, 256) \
            or sizes.shape != (4, 256):
        raise ValueError("jpeg_scan: bad operand shapes")
    cap = (-(-h // 16) * 16) * (-(-w // 16) * 16) * 4 + 4096
    out = np.empty(cap, np.uint8)
    n = lib.pt_jpeg_scan(_p(rgb, ctypes.c_uint8), w, h, _p(qt, ctypes.c_int32),
                         _p(codes, ctypes.c_uint32), _p(sizes, ctypes.c_uint8),
                         _p(out, ctypes.c_uint8), cap)
    if n < 0:
        raise RuntimeError(f"jpeg_scan: the scan of a {w}x{h} frame outgrew {cap} bytes")
    jpeg_scan.calls += 1
    return out[:n].tobytes()


jpeg_scan.calls = 0

ENTRY_POINTS = (accumulate, accumulate_soa, tonemap, clear_and_sum_pathlengths, load_balance,
                jpeg_scan)
