"""K8's fp8 variants on the card's fp8 tensor cores (e4m3 wgmma, QGMMA).

    python -m ipu_path_trace_tpu_torch.probes.fp8_qgmma     # one H100

The port's fp8 kernel (csrc/quant_probe.cu, ``ChainK8Wide``) runs the e4m3
codes as their bf16 values on the bf16 tile: HGMMA with f32 sums, exact,
within K8's fp8 budget.  This probe measures the route it did not take.
It rebuilds ``csrc/quant_probe.cu`` from a copy of ``csrc/`` with source
edits, as probes/chain_ablation.py does, under build/ablation/:

  qgmma           the fp8 variants on the 8-bit tile (the e4m3 codes in
                  the s8 slice image: one byte per value, the 64-byte
                  swizzle), e4m3 x e4m3 -> f32 wgmma, the same epilogue;
                  each sum left in the tensor core for a layer's K;
  qgmma_promoted  the same with each 64-input slice's sum taken out of the
                  tensor core and added into f32 registers (the remedy of
                  the DeepSeek-V3 report, arXiv 2412.19437, 3.3.2), every
                  hidden layer in passes of 128 outputs so that a third
                  accumulator set fits.

For fp8_e4m3 and fp8_raw at the script's 1,105,920 rays it times the
port's kernel and each route, and gives each one's relative error against
the script's f32 chain and against the plain version (median, share of the
outputs past 1e-2, max; probes/quant.probe_plain).  It does the same for
the cuBLAS fp8 chain with the script's epilogue (``scaled_mm_chain``, with
and without fast accumulation): a second witness that the error is the
fp8 tensor cores' own.  It also counts each route kernel's MMA
instructions (cuobjdump) and ptxas spills, and times back-to-back e4m3
and s8 wgmma m64n256k32 on every SM.  Prints one line per measurement and
one JSON line with the card's nvidia-smi name and power limit.  The edits
follow today's chain and raise once their text is gone.  Needs CUDA and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..ops import _lib
from ..ops.nif import chain_plan, chain_slices, pad_rows, wg_net
from ..utils.devtime import card_line, time_per_call
from . import quant
from .chain_ablation import build_variant

ROUTES = ("qgmma", "qgmma_promoted")
FP8 = ("fp8_e4m3", "fp8_raw")
H, Q = "nif_wgmma.cuh", "quant_probe.cu"
BENCH_ITERS = 20000  # iterations of four wgmma per warpgroup in the rate microbenchmark


def _wgmma_e4m3(n: int) -> str:
    """The specialisation wgmma_e4m3<n>: d[64 x n] += A[64 x 32] * B[32 x n],
    e4m3 x e4m3 -> f32, both operands K-major in shared memory."""
    regs = n // 2
    d = ", ".join(f"%{i}" for i in range(regs))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return (f"template <>\nPT_HD void wgmma_e4m3<{n}>(float (&d)[{regs}], uint64_t da, "
            f"uint64_t db) {{\n  asm volatile(\n"
            f'      "{{\\n .reg .pred p;\\n setp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
            f'      " wgmma.mma_async.sync.aligned.m64n{n}k32.f32.e4m3.e4m3 {{"\n'
            f'      "{d}"\n      "}}, %{regs}, %{regs + 1}, p, 1, 1;\\n}}\\n"\n'
            f'      : {outs}\n      : "l"(da), "l"(db), "r"(1));\n}}\n\n')


# The chain as it stands dispatches an 8-bit chain to s8 wgmma; a chain
# whose 8-bit accumulators are f32 (the fp8 variants' ChainK8 below) issues
# e4m3 wgmma instead.
_E4M3 = "std::is_same<typename Ch::Acc, float>::value"
QGMMA_EDITS = [
    (H, "// The MMA of chain policy Ch on N outputs:",
     "template <int N>\nPT_HD void wgmma_e4m3(float (&d)[N / 2], uint64_t da, uint64_t db);\n\n"
     + "".join(_wgmma_e4m3(n) for n in (8, 64, 128, 192, 256))
     + "// The MMA of chain policy Ch on N outputs:"),
    (H, """  if constexpr (Ch::kInt8)
    wgmma_s8<N>(d, da, db);""", f"""  if constexpr (Ch::kInt8 && {_E4M3})
    wgmma_e4m3<N>(d, da, db);
  else if constexpr (Ch::kInt8)
    wgmma_s8<N>(d, da, db);"""),
    (Q, "struct ChainK8 : K8Epilogue<V, int> {",
     "struct ChainK8 : K8Epilogue<V, typename std::conditional<(V >= kFp8), float, int>::type> {"),
    (Q, "typename std::conditional<(V < kFp8), ChainK8<V>, ChainK8Wide<V>>::type",
     "ChainK8<V>"),
]
# Promotion: each slice's products summed from zero in the tensor core,
# waited for and added into the f32 accumulators; every hidden layer of the
# e4m3 chain runs in wg_skip's passes (one dot and one multiplier where the
# layer has no feature slices), and the plan's passes say so.
PROMOTE_EDITS = QGMMA_EDITS + [
    (H, "// One pass of the 8-bit skip layer over NH outputs", """constexpr int kWgPromoteSteps = 2;  // K steps per promoted part: one 64-input slice

template <class Ch, int NH, class Hook>
PT_HD void wg_promoted_dots(const NifWg& net, int l, WgPipe& p, uint32_t a_act, uint32_t a_feat,
                            int lane, float (&acc)[NH / 2], float (&accf)[NH / 2],
                            const Hook& hook) {
  wg_zero(acc);
  wg_zero(accf);
  const int ia = net.in_atoms[l], slices = ia + net.f_atoms[l];
  const int split = ia && net.f_atoms[l] ? ia : slices;  // slices into acc, the rest into accf
  auto dots = [&](int s, float (&d)[NH / 2]) {
    uint64_t da, db;
    wg_slice_begin<true>(net, l, s, p, a_act, a_feat, da, db);
#pragma unroll
    for (int k0 = 0; k0 < kWgKSteps<true>; k0 += kWgPromoteSteps) {
      float part[NH / 2];
      wg_zero(part);
      wg_fence_regs(part);
      wg_fence();
#pragma unroll
      for (int ks = k0; ks < k0 + kWgPromoteSteps; ++ks)
        wg_mma<Ch, NH>(part, da + 2 * ks, db + 2 * ks);
      wg_commit();
      if (s == slices - 1 && k0 + kWgPromoteSteps == kWgKSteps<true>) hook(l);
      wg_wait<0>();
      wg_fence_regs(part);
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) d[i] += part[i];
    }
    wg_release(p.empty, p.stage, lane);
    wg_advance(net, p);
  };
  for (int s = 0; s < split; ++s) dots(s, acc);
  for (int s = split; s < slices; ++s) dots(s, accf);
}

// One pass of the 8-bit skip layer over NH outputs"""),
    (H, """                        typename Ch::Acc (&accf)[NH / 2], const Hook& hook) {
  wg_zero(acc);""", f"""                        typename Ch::Acc (&accf)[NH / 2], const Hook& hook) {{
  if constexpr ({_E4M3}) {{
    wg_promoted_dots<Ch, NH>(net, l, p, a_act, a_feat, lane, acc, accf, hook);
    return;
  }}
  wg_zero(acc);"""),
    (H, """    return wg_codes([&](int h, int e) {
      return Ch::code(Ch::skip(""", f"""    return wg_codes([&](int h, int e) {{
      if constexpr ({_E4M3}) {{
        if (!(net.in_atoms[l] && net.f_atoms[l]))
          return Ch::code(Ch::dense(acc[4 * i + 2 * h + e], e ? m.y : m.x, e ? bias.y : bias.x),
                          inv);
      }}
      return Ch::code(Ch::skip("""),
    (H, """    if constexpr (Ch::kInt8) {  // the skip layer: two dots
      if (net.in_atoms[l] && net.f_atoms[l]) {""", f"""    if constexpr (Ch::kInt8) {{
      if ({_E4M3} || (net.in_atoms[l] && net.f_atoms[l])) {{"""),
    (H, "net.passes[l] != (net.int8 && net.in_atoms[l] && net.f_atoms[l] && net.chunks[l]",
     "net.passes[l] != (net.int8 && net.chunks[l]"),
]
EDITS = {"qgmma": QGMMA_EDITS, "qgmma_promoted": PROMOTE_EDITS}

BENCH = r'''
#include "nif_wgmma.cuh"
using namespace pt;
// Back-to-back wgmma m64n256k32 from shared memory under the 64-byte
// swizzle: e4m3 (QGMMA) or s8 (IGMMA).
template <bool kE4m3>
__global__ void __launch_bounds__(256, 1) bench(int iters, int* sink) {
  extern __shared__ __align__(1024) unsigned char smem[];
  for (int i = threadIdx.x; i < 65536 / 16; i += 256)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0x01010101, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();
  const uint32_t base = smem_u32(smem);
  const int wg = threadIdx.x >> 7;
  int acc[128];
  float accf[128];
  wg_zero(acc);
  wg_zero(accf);
  const uint64_t da = wg_desc<true>(base + wg * 4096), db = wg_desc<true>(base + 16384);
  for (int it = 0; it < iters; ++it) {
    wg_fence_regs(acc);
    wg_fence_regs(accf);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (kE4m3) wgmma_e4m3<256>(accf, da + 2 * (ks & 1), db + 2 * (ks & 1));
      else wgmma_s8<256>(acc, da + 2 * (ks & 1), db + 2 * (ks & 1));
    }
    wg_commit();
    wg_wait<1>();
    wg_fence_regs(acc);
    wg_fence_regs(accf);
  }
  wg_wait<0>();
  wg_fence_regs(acc);
  wg_fence_regs(accf);
  int s = 0;
  for (int i = 0; i < 128; ++i) s += acc[i] + (int)accf[i];
  sink[blockIdx.x * 256 + threadIdx.x] = s;
}
extern "C" int run(int e4m3, int iters, int blocks, int* sink, float* ms) {
  void (*k)(int, int*) = e4m3 ? bench<true> : bench<false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536 + 1024);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  k<<<blocks, 256, 65536 + 1024>>>(iters, sink);
  cudaEventRecord(a);
  k<<<blocks, 256, 65536 + 1024>>>(iters, sink);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  cudaEventElapsedTime(ms, a, b);
  return (int)cudaGetLastError();
}
'''


def build_routes() -> dict:
    """Each route's library (csrc/quant_probe.cu of an edited copy) and the
    rate microbenchmark, compiled in parallel: {name: (path, nvcc log)}."""
    jobs = {}
    for route, edits in EDITS.items():
        csrc = build_variant(f"fp8_{route}", edits)
        jobs[route] = (csrc / Q, csrc.parent / f"{route}.so")
        if route == "qgmma":  # the bench needs the copy's wgmma_e4m3
            (csrc / "bench.cu").write_text(BENCH)
            jobs["bench"] = (csrc / "bench.cu", csrc.parent / "bench.so")
    procs = {name: subprocess.Popen([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", str(so),
                                     str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, (src, so) in jobs.items()}
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"fp8 qgmma: nvcc failed on {name}:\n{log[-4000:]}")
        out[name] = (jobs[name][1], log)
    return out


def qgmma_net(ops: quant.ProbeOperands, route: str):
    """A route's chain argument for an fp8 variant's operands: (NifWg, the
    tensors it points to).  The plan is the 8-bit one (probe_plan's for the
    int8 codes; promoted: every hidden layer in passes), the slices the
    e4m3 codes' bytes in the s8 slice image (e4m3 dtype), the multipliers
    and quant steps as the port's kernel takes them."""
    if route not in ROUTES or ops.variant not in FP8:
        raise ValueError(f"fp8 qgmma: no route {route!r} for {ops.variant}")
    dims = [(k, out, i == quant.SKIP) for i, (out, k) in enumerate(w.shape for w in ops.weights)]
    plan = chain_plan(dims, ops.feats.shape[0], 1, what=f"the {route} chain")
    if route == "qgmma_promoted":
        most = max(lay["passes"] for lay in plan["layers"])
        for lay in plan["layers"]:
            lay["passes"] = -(-lay["chunks"] // 2) if lay["chunks"] else 1
        if max(lay["passes"] for lay in plan["layers"]) != most:
            raise ValueError("fp8 qgmma: promotion would change the plan's codes area")
    mults, mf, inv = quant._scales(ops)
    operands = [(chain_slices(lay, w.view(torch.uint8)).view(w.dtype),
                 pad_rows(b.reshape(-1).float().contiguous(), lay["rows"]))
                for lay, w, b in zip(plan["layers"], ops.weights, ops.biases)]
    scales = ([pad_rows(m, lay["rows"]) for lay, m in zip(plan["layers"], mults)],
              pad_rows(mf, quant.HIDDEN), inv)
    net = wg_net(plan, operands, quant.EMBED, False, 1.0, (0.0, 0.0, 0.0), scales)
    return net, (plan, operands, scales)


def run_route(lib: ctypes.CDLL, ops: quant.ProbeOperands, net) -> torch.Tensor:
    """One launch of a route's kernel over ``ops.feats`` -> (8, n) f32."""
    rows, n = ops.feats.shape
    out = torch.empty((8, n), dtype=torch.float32, device=ops.feats.device)
    _lib.check(lib.pt_quant_probe(ctypes.byref(net), quant.VARIANTS.index(ops.variant),
                                  _lib.ptr(ops.feats), rows, n, _lib.ptr(out),
                                  _lib.stream(ops.feats.device)), f"fp8 qgmma {ops.variant}")
    return out


def scaled_mm_chain(ops: quant.ProbeOperands, fast_accum: bool) -> torch.Tensor:
    """K8's fp8 chain (the script's epilogue, as probes/quant.probe_plain)
    with each dot a cuBLAS fp8 product, torch._scaled_mm (e4m3 -> f32, unit
    scales; fast_accum: the sums left in the tensor core, else promoted by
    cuBLAS): what the card's fp8 tensor cores give for the plain version's
    function, a yardstick the port never calls."""
    u8, f8 = torch.uint8, torch.float8_e4m3fn
    one = torch.ones((), device=ops.feats.device)

    def dot(w, x):  # (out, K) e4m3 x (K, n) e4m3 -> (out, n) f32
        b = torch.cat([w.view(u8), w.view(u8).new_zeros((-w.shape[0] % 16, w.shape[1]))])
        y = torch._scaled_mm(x.view(u8).t().contiguous().view(f8), b.view(f8).t(),
                             scale_a=one, scale_b=one, out_dtype=torch.float32,
                             use_fast_accum=fast_accum)
        return y[:, :w.shape[0]].t()

    scal, x = ops.scal, ops.feats
    for i, (w, b) in enumerate(zip(ops.weights, ops.biases)):
        if i == quant.SKIP:
            t = w.shape[1] - ops.feats.shape[0]
            y = quant._fma(dot(w[:, :t].contiguous(), x), scal[3 * i],
                           dot(w[:, t:].contiguous(), ops.feats) * scal[3 * i + 2]) + b
        else:
            y = quant._fma(dot(w, x), scal[3 * i], b)
        if i == len(ops.weights) - 1:
            return y
        y = torch.relu(y)
        x = quant.to_e4m3(y * scal[3 * i + 1] if ops.variant == "fp8_e4m3" else y)


def vs_plain(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Relative error against the plain version, floored at 1% of its peak
    (chip_smoke.py's FP8_* rule): the median, the share of outputs past
    1e-2 and the largest."""
    rel = (got - ref).abs() / (ref.abs() + 1e-2 * ref.abs().max())
    return {"median": float(rel.median()), "above_1e-2": float((rel > 1e-2).float().mean()),
            "max": float(rel.max())}


def sass_counts(so: Path) -> dict:
    """MMA opcodes of the library's fp8 kernels (cuobjdump), by variant;
    empty without cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        return {}
    sass = subprocess.run([exe, "-sass", str(so)], capture_output=True, text=True,
                          timeout=300).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.match(r"\S*21quant_probe_wg_kernelILi([45])EE", part)
        if m:
            out[quant.VARIANTS[int(m[1])]] = {op: part.count(f" {op}.") for op in (
                "QGMMA", "HGMMA", "IGMMA", "HMMA", "QMMA", "IMMA")}
    return out


def spill_bytes(log: str) -> dict:
    """ptxas's spill stores + loads of the fp8 kernels, by variant."""
    out = {}
    for v in (4, 5):
        m = re.search(rf"quant_probe_wg_kernelILi{v}EE[^']*'.*?(\d+) bytes spill stores, "
                      rf"(\d+) bytes spill loads", log, re.S)
        out[quant.VARIANTS[v]] = int(m[1]) + int(m[2]) if m else None
    return out


def wgmma_rates(so: Path) -> dict:
    """TOP/s of back-to-back wgmma m64n256k32 on every SM, e4m3 and s8."""
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.empty(sms * 256, dtype=torch.int32, device="cuda")
    ms = ctypes.c_float()
    rates = {}
    for e4m3, name in ((1, "e4m3_k32_swizzle64"), (0, "s8_k32_swizzle64")):
        _lib.check(lib.run(e4m3, BENCH_ITERS, sms, sink.data_ptr(), ctypes.byref(ms)), name)
        ops = 2 * sms * 2 * BENCH_ITERS * 4 * 64 * 256 * 32  # 2 warpgroups, 4 wgmma each
        rates[name] = ops / (ms.value * 1e-3) / 1e12
    return rates


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("fp8 qgmma: CUDA is not available; it times the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line(dev)
    built = build_routes()
    libs = {}
    for route in ROUTES:
        libs[route] = lib = ctypes.CDLL(str(built[route][0]))
        lib.pt_quant_probe.argtypes = [ctypes.POINTER(_lib.NifWg), ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p]
        lib.pt_quant_probe.restype = ctypes.c_int
    results = {"card": card, "rays": quant.RAYS, "variants": {},
               "sass": {r: sass_counts(built[r][0]) for r in ROUTES},
               "spill_bytes": {r: spill_bytes(built[r][1]) for r in ROUTES}}
    for route in ROUTES:
        print(f"{route} SASS: {results['sass'][route]}; ptxas spill bytes "
              f"{results['spill_bytes'][route]} ({card})", flush=True)
    feats, ws, bs, ref, xmax = quant.calibration(quant.PAD)
    for variant in FP8:
        ops = quant.build_operands(variant, ws, bs, feats, xmax).to(dev)
        plain = quant.probe_plain(ops)
        nets = {r: qgmma_net(ops, r) for r in ROUTES}
        fns = {"port kernel (exact, bf16 HGMMA)": lambda: quant.quant_probe(ops),
               **{f"{r} (QGMMA)": lambda r=r: run_route(libs[r], ops, nets[r][0])
                  for r in ROUTES},
               **{f"torch._scaled_mm chain (use_fast_accum={f})":
                  lambda f=f: scaled_mm_chain(ops, f) for f in (True, False)}}
        results["variants"][variant] = entries = {}
        for name, fn in fns.items():
            out = fn()
            ms = time_per_call(fn, 20, dev) * 1e3
            out_h = out.cpu().numpy()[:ref.shape[0]]
            entries[name] = e = {"ms_per_sample": ms,
                                 "rel_err_vs_f32": float(np.abs(out_h - ref).max()
                                                         / np.abs(ref).max()),
                                 "vs_plain": vs_plain(out, plain)}
            vp = e["vs_plain"]
            print(f"{variant} {name}: {ms:.3f} ms per {quant.RAYS}-ray sample, rel_err vs f32 "
                  f"{e['rel_err_vs_f32']:.3e}; against the plain version median "
                  f"{vp['median']:.3e}, {vp['above_1e-2']:.3e} past 1e-2, max {vp['max']:.4g} "
                  f"({card})", flush=True)
            del out
        del plain, nets
    results["wgmma_tops"] = wgmma_rates(built["bench"][0])
    for name, tops in results["wgmma_tops"].items():
        print(f"wgmma m64n256 {name}: {tops:.1f} TOP/s ({card})", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
