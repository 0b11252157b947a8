// K8: the precision probe - the canonical 6x320 E=12 chain (+ head) over
// precomputed Fourier features, in one of six arithmetics.
//
// Replaces scripts/quant_probe.py::build_call (kernel bodies _bf16_kernel
// :142, _int8_perchan_kernel :161, _narrow_kernel :197).  Two kernel
// bodies, each instantiated per variant:
//
//  * quant_probe_wg_kernel<V>, the wgmma chains of nif_wgmma.cuh (128-ray
//    tiles, the weights streamed through shared memory; probes/quant.py
//    packs the slices and the plan), with the features read from the
//    input in place of the encode:
//     - bf16: the (48, n) f32 features cast to bf16, the bf16 chain
//       (ChainBf16: f32 bias + ReLU, the skip concat) and a decode of
//       y * 1 + 0; out (3, n);
//     - int8_requant / int8_perchan / int8_raw: the (64, n) int8 codes as
//       they are, s8 x s8 -> s32 wgmma, the epilogue below (ChainK8<V>);
//       out (8, n), all eight head rows;
//  * quant_probe_kernel<V>, fp8_e4m3 / fp8_raw: a block of kThreads
//    threads runs a tile of kTile rays on the mma.sync fragments of
//    nif_dev.cuh (ray-major 8-bit activations, plain ldmatrix), m16n8k32
//    e4m3 x e4m3 -> f32 (mma_rows_e4m3).  On sm_90 that instruction runs
//    as f16 HMMA, not the fp8 tensor-core path (QGMMA, wgmma only): a
//    later slice moves it, with the quality gate's fp8 arm.
//
// The narrow epilogue is the script's: y = acc * m_l + b, at the skip
// layer (two dots: trunk columns against the activations, feature
// columns against the 64 feature rows) y = acc * m_l + accf * mf + b, with
// m_l and mf per output channel (int8_perchan) or one value repeated;
// hidden layers then ReLU (NaN kept, as jnp.maximum) and the next codes:
// clip(rint(y * inv_l), +-127) (int8 requant), y truncated toward zero and
// saturated (int8 raw: JAX's f32 -> int8 cast), e4m3(y * inv_l) or e4m3(y)
// rounded to nearest even with NaN past 464 (JAX's f32 -> e4m3 cast, not
// the saturating one).  The products acc * m_l are fused with the term
// that follows (fmaf), as XLA fuses the reference's expression; every
// other product and sum rounds on its own (--fmad=false), as the plain
// version's (probes/quant.py) do.
//
// What bounds it: the chain, 0.55 M multiply-adds per ray (1.2 TFLOP per
// 1,105,920-ray sample in bf16, the same count of 8-bit operations at
// twice the peak), as K2 (nif_wgmma.cuh says what holds each chain).
#include <type_traits>

#include "nif_wgmma.cuh"

namespace pt {

enum K8Variant { kBf16 = 0, kInt8Requant, kInt8Perchan, kInt8Raw, kFp8, kFp8Raw };

// f32 -> e4m3 code as JAX casts: round to nearest even, NaN of the
// input's sign past 464 (what __nv_cvt_float_to_fp8 gives with __NV_NOSAT).  The hardware
// conversion saturates, so the overflow is patched here; at most 464 it
// rounds as the non-saturating one.
__device__ __forceinline__ uint8_t f32_to_e4m3(float x) {
  unsigned short r;
  asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;" : "=h"(r) : "f"(0.0f), "f"(x));
  return fabsf(x) > 464.0f ? (uint8_t)(x < 0.0f ? 0xFF : 0x7F) : (uint8_t)(r & 0xFF);
}

// The code of hidden activation y (after ReLU) for the next layer.
template <int V>
__device__ __forceinline__ uint8_t next_code(float y, float inv) {
  if constexpr (V == kInt8Requant || V == kInt8Perchan) {
    return (uint8_t)(int8_t)(int)fminf(fmaxf(rintf(y * inv), -127.0f), 127.0f);
  } else if constexpr (V == kInt8Raw) {  // cvt.rzi: toward zero, NaN -> 0
    return (uint8_t)(int8_t)min(max(__float2int_rz(y), -128), 127);
  } else if constexpr (V == kFp8) {
    return f32_to_e4m3(y * inv);
  } else {
    return f32_to_e4m3(y);
  }
}

// The int8 variants' chain on the wgmma tile: the script's epilogue with
// the accumulators of wgmma s8, the head's eight rows as they are.
template <int V>
struct ChainK8 {
  static constexpr bool kInt8 = true;
  static constexpr int kHeadOutputs = 8;
  using Acc = int;
  PT_HD static float dense(int acc, float m, float b) { return fmaf((float)acc, m, b); }
  PT_HD static float skip(int acc, int accf, float m, float ms, float b) {
    return fmaf((float)acc, m, (float)accf * ms) + b;
  }
  PT_HD static uint32_t code(float y, float inv) { return next_code<V>(y < 0.0f ? 0.0f : y, inv); }
  PT_HD static float head(const NifWg& net, int l, int o, int acc) {
    return dense(acc, net.mult[l][o], net.b[l][o]);
  }
};

// The probe's ends on the wgmma tile: `rows` feature rows of the (rows, n)
// input in place of the encode (bf16: f32 values cast; int8: the codes as
// they are), the head's rows into the (kHeadOutputs, n) output.
struct WgProbeIo {
  static constexpr bool kFeatures = true;
  const void* feats;
  int rows, n;
  float* out;
  template <bool kInt8>
  PT_HD void put(unsigned char* feat, int row, int k, int p) const {
    if constexpr (kInt8)
      feat[wg_offset<true>(row, k)] = p < n ? ((const uint8_t*)feats)[(size_t)k * n + p] : 0;
    else
      *reinterpret_cast<uint16_t*>(feat + wg_offset<false>(row, k)) =
          f32_to_bf16(p < n ? ((const float*)feats)[(size_t)k * n + p] : 0.0f);
  }
  PT_HD void store(int o, int p, float y) const { out[(size_t)o * n + p] = y; }
};

template <int V>
__global__ void __launch_bounds__(kWgThreads, 1) quant_probe_wg_kernel(NifWg net,
                                                                     const void* __restrict__ feats,
                                                                     int rows, int n,
                                                                     float* __restrict__ out) {
  using Chain = typename std::conditional<V == kBf16, ChainBf16, ChainK8<V>>::type;
  nif_wg_tiles<Chain>(net, WgProbeIo{feats, rows, n, out});
}

// One pass of fp8 layer l over the warp's output tiles j0 + q * kWarps:
// the dots, the epilogue; hidden layers write codes out[ray][o], the head
// writes y to row o of the (8, n) output.
template <int V, int Q, bool kSkip>
__device__ inline void k8_layer_pass(const NifNet& net, int l, const uint8_t* in, int in_stride,
                                     const uint8_t* feat, int feat_stride, uint8_t* out,
                                     int out_stride, float* __restrict__ y_out, int n, int tile0,
                                     int j0, int lane) {
  const int fan_out = net.fan_out[l], k_trunk = net.k_trunk[l], k_pad = net.k_pad[l];
  const int n_tiles = (fan_out + 7) / 8;
  const bool last = l == net.num_layers - 1;
  const uint8_t* w = (const uint8_t*)net.w[l];
  float acc[Q][kMTiles][4] = {};
  float accf[kSkip ? Q : 1][kMTiles][4] = {};
  mma_rows_e4m3<Q>(acc, in, in_stride, k_trunk / 32, w, k_pad, 0, n_tiles, j0, lane);
  if constexpr (kSkip)
    mma_rows_e4m3<Q>(accf, feat, feat_stride, (k_pad - k_trunk) / 32, w, k_pad, k_trunk, n_tiles,
                     j0, lane);
  const int g = lane >> 2, tg = lane & 3;
  const float inv = net.inv_next[l];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = j0 + q * kWarps;
    if (j >= n_tiles) continue;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // C fragment: (ray g [+8], output 2 tg [+1])
        const int o = j * 8 + tg * 2 + (e & 1);
        const int ray = mt * 16 + g + (e >> 1) * 8;
        if (o >= fan_out) continue;
        const float m = __ldg(net.mult[l] + o);
        float y;
        if constexpr (kSkip)
          y = fmaf(acc[q][mt][e], m, accf[q][mt][e] * __ldg(net.mult_skip + o)) +
              __ldg(net.b[l] + o);
        else
          y = fmaf(acc[q][mt][e], m, __ldg(net.b[l] + o));
        if (last) {
          if (tile0 + ray < n) y_out[(size_t)o * n + tile0 + ray] = y;
        } else {
          out[ray * out_stride + o] = next_code<V>(y < 0.0f ? 0.0f : y, inv);
        }
      }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, 2) quant_probe_kernel(NifNet net, NifSmem plan,
                                                                const void* __restrict__ feats,
                                                                int n, float* __restrict__ out) {
  static_assert(V == kFp8 || V == kFp8Raw, "bf16 and int8 run quant_probe_wg_kernel");
  extern __shared__ __align__(16) unsigned char smem[];
  const NifTile t(smem, plan);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile0 = blockIdx.x * kTile;
  const int rows = net.fan_in[0];  // feature rows: 64 (zero padded)
  // (rows, n) 8-bit codes -> ray-major [ray][row8(rows)]: the transpose
  // of the feature-major input, one byte per thread and step.
  const uint8_t* f = (const uint8_t*)feats;
  const int fs = row8(rows), as = row8(net.max_width);
  uint8_t* const fb = t.feat;
  for (int idx = tid; idx < rows * kTile; idx += kThreads) {
    const int r = idx / kTile, ray = idx % kTile;
    fb[ray * fs + r] = tile0 + ray < n ? f[(size_t)r * n + tile0 + ray] : (uint8_t)0;
  }
  __syncthreads();
  const uint8_t* in = fb;
  int in_stride = fs;
  uint8_t* o8 = t.buf0;
  for (int l = 0; l < net.num_layers; ++l) {
    const int n_tiles = (net.fan_out[l] + 7) / 8;
    if (net.skip[l]) {
      for (int j0 = warp; j0 < n_tiles; j0 += kQSkip * kWarps)
        k8_layer_pass<V, kQSkip, true>(net, l, in, in_stride, fb, fs, o8, as, out, n, tile0, j0,
                                       lane);
    } else {
      for (int j0 = warp; j0 < n_tiles; j0 += kQMax * kWarps)
        k8_layer_pass<V, kQMax, false>(net, l, in, in_stride, fb, fs, o8, as, out, n, tile0, j0,
                                       lane);
    }
    __syncthreads();
    in = o8;
    in_stride = as;
    o8 = o8 == t.buf0 ? t.buf1 : t.buf0;
  }
}

template <int V>
int launch_quant_probe(const NifNet& net, const void* feats, int n, float* out, void* stream) {
  const NifSmem plan = nif_smem_plan(net, 0);
  cudaError_t err = cudaFuncSetAttribute(quant_probe_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kTile - 1) / kTile;
  if (blocks == 0) return 0;
  quant_probe_kernel<V><<<blocks, kThreads, plan.total, (cudaStream_t)stream>>>(net, plan, feats,
                                                                               n, out);
  return (int)cudaGetLastError();
}

template <int V>
int launch_quant_probe_wg(const NifWg& net, const void* feats, int rows, int n, float* out,
                          void* stream) {
  void (*const kernel)(NifWg, const void*, int, int, float*) = quant_probe_wg_kernel<V>;
  if ((V == kBf16) == (net.int8 != 0)) return (int)cudaErrorInvalidValue;
  return launch_wg(kernel, net, n, stream, net, feats, rows, n, out);
}

}  // namespace pt

// variant: the index in probes/quant.py::VARIANTS (bf16, int8_requant,
// int8_perchan, int8_raw, fp8_e4m3, fp8_raw).  bf16 and int8 take wg (the
// wgmma chain) and rows, the feature rows of feats; fp8 takes net.
extern "C" int pt_quant_probe(const pt::NifNet* net, const pt::NifWg* wg, int variant,
                              const void* feats, int rows, int n, float* out, void* stream) {
  const bool fp8 = variant == pt::kFp8 || variant == pt::kFp8Raw;
  if ((fp8 ? (const void*)net : (const void*)wg) == nullptr) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case pt::kBf16: return pt::launch_quant_probe_wg<pt::kBf16>(*wg, feats, rows, n, out, stream);
    case pt::kInt8Requant:
      return pt::launch_quant_probe_wg<pt::kInt8Requant>(*wg, feats, rows, n, out, stream);
    case pt::kInt8Perchan:
      return pt::launch_quant_probe_wg<pt::kInt8Perchan>(*wg, feats, rows, n, out, stream);
    case pt::kInt8Raw:
      return pt::launch_quant_probe_wg<pt::kInt8Raw>(*wg, feats, rows, n, out, stream);
    case pt::kFp8: return pt::launch_quant_probe<pt::kFp8>(*net, feats, n, out, stream);
    case pt::kFp8Raw: return pt::launch_quant_probe<pt::kFp8Raw>(*net, feats, n, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
