"""What holds the wgmma NIF chains: ablations of K3 and K4, and wgmma's rate.

    python -m ipu_path_trace_tpu_torch.probes.chain_ablation     # one H100

Each ablation rebuilds the kernels from a copy of ``csrc/`` with one
source edit and times K4 (the NIF at 1,104,000 points) and K3 (an 8-sample
step at 1104x1000, per sample) for the bf16 and the int8 chain:

  base          the kernels as they are;
  no-copy       the producer arrives on each ring stage instead of copying
                the slice (the consumers run on stale weights): the weight
                stream's share;
  no-mma        the consumers issue no wgmma: the MMAs' share;
  no-epilogue   the int8 epilogue's f32 requant replaced by an integer mix
                of the accumulators (bf16 unchanged): its share.

Their results are wrong by design; only the times mean anything.  Then a
microbenchmark times back-to-back wgmma m64n256 with both operands in
shared memory - bf16 k16 under the 128-byte swizzle, s8 k32 under the
64-byte (the int8 chain's) and the 128-byte swizzle - on every SM: the
rate each kind can reach outside the chain.  Prints one line per
measurement and one JSON line with the card's nvidia-smi name and power
limit.  Needs CUDA and nvcc; the builds go to build/ablation/.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import torch

from ..ops import _lib
from ..utils.devtime import card_line, time_per_call

ROOT = Path(__file__).resolve().parents[2]  # the checkout: assets/, build/
BENCH_ITERS = 20000  # iterations of four wgmma per warpgroup in the rate microbenchmark
H = "nif_wgmma.cuh"
# Source edits of each ablation: (file, text, replacement).  They follow
# the chain as it is; a text no longer found raises at build time, so an
# edit never silently stops applying after the chain changes.
ABLATIONS = {
    "base": [],
    "no-copy": [(H, """          mbar_expect_tx(full + 8 * stage, bytes);
          bulk_load(ring + stage * net.stage_bytes, src + (size_t)s * slice + (size_t)pass * step,
                    bytes, full + 8 * stage);""", """          (void)bytes;
          (void)src;
          mbar_arrive(full + 8 * stage);""")],
    "no-mma": [(H, """      wg_mma<Ch, N0>(acc0, da + 2 * ks, db + 2 * ks);
      if constexpr (N1 > 0)
        wg_mma<Ch, N1>(acc1, da + 2 * ks, db + 2 * ks + N0 * kWgRowBytes<k8> / 16);""",
                """      acc0[ks] += (typename Ch::Acc)(da + db);"""),
               (H, """    for (int ks = 0; ks < kWgKSteps<true>; ++ks) wg_mma<Ch, NH>(d, da + 2 * ks, db + 2 * ks);""",
                """    for (int ks = 0; ks < kWgKSteps<true>; ++ks) d[ks] += (typename Ch::Acc)(da + db);""")],
    "no-epilogue": [(H, """    return (uint32_t)min(__float2int_rn(fmaxf(y, 0.0f) * inv), 255) ^ 0x80u;""",
                     """    return __float_as_uint(y + inv) & 0xFFu;"""),
                    (H, """  PT_HD static float dense(int acc, float m, float b) {
    const float y = (float)acc * m;
    return y + b;
  }""", """  PT_HD static float dense(int acc, float m, float b) { return __int_as_float(acc ^ __float_as_int(m + b)); }"""),
                    (H, """  PT_HD static float skip(int acc, int accf, float m, float ms, float b) {
    float y = (float)acc * m;
    y = y + (float)accf * ms;
    return y + b;
  }""", """  PT_HD static float skip(int acc, int accf, float m, float ms, float b) {
    return __int_as_float((acc + accf) ^ __float_as_int(m + ms + b));
  }""")],
}

BENCH = r'''
#include "nif_wgmma.cuh"
using namespace pt;
// MODE 0: bf16 k16, 128-byte swizzle; 1: s8 k32, 64-byte; 2: s8 k32, 128-byte.
template <int MODE>
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
  const uint64_t da = MODE == 1 ? wg_desc<true>(base + wg * 4096) : wg_desc<false>(base + wg * 8192);
  const uint64_t db = MODE == 1 ? wg_desc<true>(base + 16384) : wg_desc<false>(base + 16384);
  for (int it = 0; it < iters; ++it) {
    wg_fence_regs(acc);
    wg_fence_regs(accf);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k = MODE == 1 ? (ks & 1) : ks;  // 2 K steps per 64-byte row
      if (MODE == 0) wgmma<256>(accf, da + 2 * k, db + 2 * k);
      else wgmma_s8<256>(acc, da + 2 * k, db + 2 * k);
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
extern "C" int run(int mode, int iters, int blocks, int* sink, float* ms) {
  void (*k)(int, int*) = mode == 0 ? bench<0> : mode == 1 ? bench<1> : bench<2>;
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


def build_variant(name: str, edits) -> Path:
    """A copy of csrc/ with the edits applied, under build/ablation/."""
    src = ROOT / "ipu_path_trace_tpu_torch" / "csrc"
    dst = ROOT / "build" / "ablation" / name / "pkg" / "csrc"
    shutil.rmtree(dst.parent.parent, ignore_errors=True)
    shutil.copytree(src, dst)
    for fname, old, new in edits:
        text = (dst / fname).read_text()
        if old not in text:
            raise RuntimeError(f"ablation {name}: the edit of {fname} no longer applies")
        (dst / fname).write_text(text.replace(old, new))
    return dst


def time_chains(dev: torch.device) -> dict:
    """K4 at 1,104,000 points and K3 per 1104x1000 sample, bf16 and int8."""
    from ..core.records import to_device_batch
    from ..core.scene import default_scene
    from ..models.nif import load_nif_assets
    from ..ops import megastep, nif
    from ..render.params import RenderSettings
    from ..runtime.app import parse_env_assets
    from ..runtime.worklist import coherent_order, create_tracing_jobs

    models = {"bf16": load_nif_assets(str(ROOT / "assets/urban_alley_synth_nif"),
                                      torch.bfloat16, dev)[0],
              "int8": parse_env_assets(str(ROOT / "assets/urban_alley_synth_nif_int8"), dev,
                                       "int8")[0].model}
    scene = default_scene(dev)
    work = to_device_batch(coherent_order(create_tracing_jobs(1104, 1000), scene, 1104, 1000,
                                          90.0), dev)
    cols, rows = work.u.float(), work.v.float()
    u, v = torch.rand((2, cols.shape[0]), device=dev)
    settings = RenderSettings.make(samples_per_step=8)
    out = {}
    for chain, m in models.items():
        out[f"k4_{chain}_ms"] = time_per_call(lambda: nif.nif_apply_t(m, u, v), 10, dev) * 1e3
        out[f"k3_{chain}_ms"] = time_per_call(lambda: megastep.render_megastep(
            scene, settings, m, cols, rows, (5, 6), width=1104, height=1000,
            max_path_length=10), 3, dev) * 1e3 / 8
    return out


def wgmma_rates(iters: int) -> dict:
    """TOP/s of back-to-back wgmma on every SM, by type and swizzle."""
    out_dir = ROOT / "build" / "ablation" / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "bench.cu").write_text(BENCH)
    so = out_dir / "bench.so"
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I",
                    str(ROOT / "ipu_path_trace_tpu_torch" / "csrc"), "-o", str(so),
                    str(out_dir / "bench.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.empty(sms * 256, dtype=torch.int32, device="cuda")
    ms = ctypes.c_float()
    rates = {}
    for mode, name, k in ((0, "bf16_k16_swizzle128", 16), (1, "s8_k32_swizzle64", 32),
                          (2, "s8_k32_swizzle128", 32)):
        _lib.check(lib.run(mode, iters, sms, sink.data_ptr(), ctypes.byref(ms)), name)
        ops = 2 * sms * 2 * iters * 4 * 64 * 256 * k  # 2 warpgroups per block, 4 wgmma each
        rates[name] = ops / (ms.value * 1e-3) / 1e12
    return rates


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chain ablation: CUDA is not available; it times the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line(dev)
    csrc = _lib.CSRC
    results = {"card": card, "ablations": {}}
    try:
        for name, edits in ABLATIONS.items():
            # ops/ launch from _lib.library(): pointing it at the edited
            # copy for one pass is what makes the same entry points time it.
            _lib.CSRC = build_variant(name, edits)
            _lib.library.cache_clear()
            results["ablations"][name] = res = time_chains(dev)
            print(f"{name}: " + ", ".join(f"{k} {v:.3f}" for k, v in res.items())
                  + f" ({card})", flush=True)
    finally:
        _lib.CSRC = csrc
        _lib.library.cache_clear()
    results["wgmma_tops"] = wgmma_rates(BENCH_ITERS)
    for name, tops in results["wgmma_tops"].items():
        print(f"wgmma m64n256 {name}: {tops:.1f} TOP/s ({card})", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
