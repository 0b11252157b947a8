"""K1's design against the bodies it was chosen over, each timed alone.

    python -m ipu_path_trace_tpu_torch.probes.trace_ablation     # one H100

Each variant is ``csrc/trace.cu`` rebuilt alone from a copy of ``csrc/``
with source edits, into a library of its own under build/ablation/trace/:

  refill              the kernel as it is (lane refill once 8 lanes idle);
  refill-every        a warp refills whenever any lane is idle;
  carried-result      each lane carries its ray's result across bounces
                      (11 more live registers) instead of taking it from
                      the last bounce;
  one-ray-per-thread  the body that lane refill replaced (one thread traces
                      one ray to its end; a block of 256 per 256 rays);
  constant-tables     the scene's tables in __constant__ memory, copied
                      there before each launch, in place of shared memory.

Every variant launches with the operands of one K1 launch prepared by
``ops.trace.prepare_trace`` (the kernel alone, back to back, CUDA events),
at the main path's 1104x1000 in Philox, Sobol and host-noise mode, in
turns (each variant, then the reverse order, then again), and is checked
bit for bit against the plain version.  Prints ptxas's registers and
spills of each build, one line per mode and variant (ms per launch, each
turn), and one JSON line with the card's nvidia-smi name and power limit.
Needs CUDA and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import _lib
from ..utils.devtime import card_line, time_per_call

ROOT = Path(__file__).resolve().parents[2]  # the checkout: build/
W, H, L = 1104, 1000, 10
REPS = 100  # launches per timed turn
_LOOP_START = "  const int lane = threadIdx.x & 31;\n"
_LOOP_END = "\n}\n\n}  // namespace pt\n"
# The body that lane refill replaced, in the kernel's signature.
_ONE_RAY = """  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const TraceResult r = trace_ray(prm, sph, dsc, cols[p], rows[p],
                                  ray_noise<kRng>(prm, noise, pid, base, sample_idx, n, p));
  rad[p] = r.radiance.x;
  rad[n + p] = r.radiance.y;
  rad[2 * n + p] = r.radiance.z;
  escd[p] = r.esc_dir.x;
  escd[n + p] = r.esc_dir.y;
  escd[2 * n + p] = r.esc_dir.z;
  escw[p] = r.esc_w.x;
  escw[n + p] = r.esc_w.y;
  escw[2 * n + p] = r.esc_w.z;
  escm[p] = r.escaped;
  plen[p] = r.path_len;"""
# Source edits of each variant: (old, new), or (start, end, new) for the
# span from start up to end; a text no longer found raises at build time.
VARIANTS = {
    "refill": [],
    "refill-every": [("constexpr int kRefillLanes = 8;", "constexpr int kRefillLanes = 1;")],
    "carried-result": [
        ("  V3 o, d, tp;\n  decltype", "  V3 o, d, tp;\n  TraceResult res;\n  decltype"),
        ("          tp = V3{1.0f, 1.0f, 1.0f};\n",
         "          tp = V3{1.0f, 1.0f, 1.0f};\n          res = no_result();\n"),
        ("      TraceResult res = no_result();\n      const int before = b;  // bounces done, "
         "each of which added one to the path length\n", ""),
        ("        plen[p] = before + res.path_len;", "        plen[p] = res.path_len;")],
    "one-ray-per-thread": [
        (_LOOP_START, _LOOP_END, _ONE_RAY),
        ("  const int blocks = needed < sms * per_sm ? needed : sms * per_sm;",
         "  const int blocks = needed;")],
    "constant-tables": [
        ("constexpr int kTraceThreads = 256;",
         "constexpr int kTraceThreads = 256;\n__constant__ float c_tables[4096];"),
        ("""  extern __shared__ float s_tables[];
  load_tables(prm, sph_g, dsc_g, s_tables);
  __syncthreads();
  const float* sph = s_tables;
  const float* dsc = s_tables + prm.num_s * kSphereF;""",
         """  const float* sph = c_tables;
  const float* dsc = c_tables + prm.num_s * kSphereF;"""),
        ("  const size_t smem = pt::tables_bytes(*prm);", """  const size_t smem = 0;
  if (pt::tables_bytes(*prm) > sizeof(pt::c_tables)) return (int)cudaErrorInvalidValue;
  const size_t sph_bytes = prm->num_s * pt::kSphereF * sizeof(float);"""),
        ("  if ((err = cudaMemsetAsync(next_ray, 0, sizeof(int), s)) != cudaSuccess) return (int)err;",
         """  if ((err = cudaMemcpyToSymbolAsync(pt::c_tables, sph, sph_bytes, 0,
                                     cudaMemcpyDeviceToDevice, s)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemcpyToSymbolAsync(pt::c_tables, dsc, prm->num_d * pt::kDiscF * sizeof(float),
                                     sph_bytes, cudaMemcpyDeviceToDevice, s)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(next_ray, 0, sizeof(int), s)) != cudaSuccess) return (int)err;""")],
}


def edited(name: str, text: str, edits) -> str:
    for edit in edits:
        if len(edit) == 2:
            old, new = edit
            if old not in text:
                raise RuntimeError(f"trace ablation {name}: an edit no longer applies")
            text = text.replace(old, new)
        else:
            start, end, new = edit
            i = text.find(start)
            j = text.find(end, i + 1) if i >= 0 else -1
            if j < 0:
                raise RuntimeError(f"trace ablation {name}: a span edit no longer applies")
            text = text[:i] + new + text[j:]
    return text


def build_variants() -> tuple[dict, dict]:
    """Each variant's trace.cu built alone, all nvcc runs at once: its
    library (pt_trace bound as the port binds it) and ptxas lines."""
    procs = {}
    for name, edits in VARIANTS.items():
        dst = ROOT / "build" / "ablation" / "trace" / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(_lib.CSRC, dst)
        (dst / "trace.cu").write_text(edited(name, (dst / "trace.cu").read_text(), edits))
        procs[name] = (dst / "libtrace.so", subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", str(dst / "libtrace.so"),
             str(dst / "trace.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    argtypes = _lib.library().pt_trace.argtypes
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"trace ablation {name}: nvcc failed:\n{log[-4000:]}")
        ptxas[name] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(so))
        lib.pt_trace.argtypes = argtypes
        lib.pt_trace.restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def _equal(got, ref) -> bool:
    def t(x):
        return x.stack() if hasattr(x, "stack") else x
    return all(torch.equal(t(getattr(got, f)), t(getattr(ref, f))) for f in got._fields)


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("trace ablation: CUDA is not available; it times the card")
    from ..core.records import to_device_batch
    from ..core.scene import default_scene
    from ..ops import trace
    from ..render.params import RenderSettings
    from ..runtime.worklist import coherent_order, create_tracing_jobs

    dev = torch.device("cuda", 0)
    card = card_line(dev)
    libs, ptxas = build_variants()
    for name, lines in ptxas.items():
        print(f"[ptxas] {name}: {' | '.join(lines)}", flush=True)
    scene = default_scene(dev)
    work = to_device_batch(coherent_order(create_tracing_jobs(W, H), scene, W, H, 90.0), dev)
    cols, rows = work.u.float(), work.v.float()
    n = cols.shape[0]
    gen = np.random.default_rng(2024)
    pid = rows.to(torch.int32) * W + cols.to(torch.int32)
    base = torch.from_numpy(gen.integers(0, 4096, n).astype(np.int32)).to(dev)
    noise = torch.from_numpy(gen.uniform(0.0, 1.0, (4 + 4 * L, n)).astype(np.float32)).to(dev)
    noise[0:2] = torch.from_numpy(gen.normal(size=(2, n)).astype(np.float32)).to(dev)
    settings = RenderSettings.make(samples_per_step=8)
    kw = dict(width=W, height=H, max_path_length=L)
    modes = {"philox": dict(seed=(5, 6)),
             "sobol": dict(seed=(5, 6), sobol=(pid, base, 0x5EED5EED), sobol_dims=12),
             "host-noise": dict(noise=noise)}
    results = {"card": card, "ptxas": ptxas, "ms": {}, "bit_for_bit": {}}
    for mode, args in modes.items():
        run = trace.prepare_trace(scene, settings, cols, rows, **args, **kw)
        ref = trace.trace_sample_plain(scene, settings, cols, rows, **args, **kw)
        exact = {}
        for name, lib in libs.items():
            _lib.check(lib.pt_trace(*run.args), f"trace ablation {name}")
            exact[name] = _equal(run.out(), ref)
        turns = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1] + list(libs):
            turns[name].append(time_per_call(lambda: libs[name].pt_trace(*run.args), REPS,
                                             dev) * 1e3)
        for name, ms in turns.items():
            print(f"{mode:10s} {name:18s} {' '.join(f'{x:.4f}' for x in ms)} ms per launch "
                  f"(mean {sum(ms) / len(ms):.4f}); bit for bit {exact[name]} ({card})",
                  flush=True)
        results["ms"][mode] = turns
        results["bit_for_bit"][mode] = exact
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
