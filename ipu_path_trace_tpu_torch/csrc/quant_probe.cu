// K8: the precision probe - the canonical 6x320 E=12 chain (+ head) over
// precomputed Fourier features, in one of six arithmetics.
//
// Replaces scripts/quant_probe.py::build_call (kernel bodies _bf16_kernel
// :142, _int8_perchan_kernel :161, _narrow_kernel :197).  One kernel body,
// quant_probe_wg_kernel<V>, on the wgmma chains of nif_wgmma.cuh
// (128-ray tiles, the weights streamed through shared memory;
// probes/quant.py packs the slices and the plan), with the features read
// from the input in place of the encode:
//  - bf16: the (48, n) f32 features cast to bf16, the bf16 chain
//    (ChainBf16: f32 bias + ReLU, the skip concat) and a decode of
//    y * 1 + 0; out (3, n);
//  - int8_requant / int8_perchan / int8_raw: the (64, n) int8 codes as
//    they are, s8 x s8 -> s32 wgmma (IGMMA), the epilogue below
//    (ChainK8<V>); out (8, n), all eight head rows;
//  - fp8_e4m3 / fp8_raw: the (64, n) e4m3 codes and weights as their bf16
//    values (exact: an e4m3 value has 4 significant bits) on the bf16
//    tile, bf16 wgmma (HGMMA) with f32 sums as the plain version's, the
//    same epilogue, each code stored as its bf16 value (ChainK8Wide<V>;
//    the skip layer's two dots by wg_skip_wide); out (8, n).  Not the
//    card's fp8 MMA: e4m3 wgmma (QGMMA) keeps only part of a sum's bits
//    and breaks K8's fp8 budget, as cuBLAS's fp8 chain does (PERF.md;
//    probes/fp8_qgmma.py rebuilds this kernel on QGMMA and measures it).
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

// e4m3 code -> the bf16 bits of its value, exact (an e4m3 value has 4
// significant bits, its exponents fit f16's): e4m3 -> f16 -> f32 by the
// hardware's conversions, then the f32's top half; NaN stays NaN.
PT_HD uint32_t e4m3_to_bf16(uint32_t code) {
  uint32_t h2;
  float f;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"((unsigned short)code));
  asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"((unsigned short)(h2 & 0xFFFFu)));
  return __float_as_uint(f) >> 16;
}

// The script's narrow epilogue (its products and sums in its order).
template <int V, class A>
struct K8Epilogue {
  static constexpr int kHeadOutputs = 8;
  using Acc = A;
  PT_HD static float dense(Acc acc, float m, float b) { return fmaf((float)acc, m, b); }
  PT_HD static float skip(Acc acc, Acc accf, float m, float ms, float b) {
    return fmaf((float)acc, m, (float)accf * ms) + b;
  }
  PT_HD static uint32_t code(float y, float inv) { return next_code<V>(y < 0.0f ? 0.0f : y, inv); }
  PT_HD static float head(const NifWg& net, int l, int o, Acc acc) {
    return dense(acc, net.mult[l][o], net.b[l][o]);
  }
};

// The int8 variants' chain on the s8 tile: wgmma s8's accumulators, the
// head's eight rows as they are.
template <int V>
struct ChainK8 : K8Epilogue<V, int> {
  static constexpr int kOp = 1;
  static constexpr bool kInt8 = true;
};

// The fp8 variants' chain: the same epilogue on the bf16 tile, the codes
// as their bf16 values, bf16 wgmma with f32 sums; a hidden layer stores
// each code's bf16 value (act).
template <int V>
struct ChainK8Wide : K8Epilogue<V, float> {
  static constexpr int kOp = 2;
  static constexpr bool kInt8 = false;
  static constexpr bool kNarrow = true;
  PT_HD static uint32_t act(float y, float inv) {
    return e4m3_to_bf16(K8Epilogue<V, float>::code(y, inv));
  }
};

// The probe's ends on the wgmma tile: `rows` feature rows of the (rows, n)
// input in place of the encode (bf16: f32 values cast; int8: the codes as
// they are; fp8: the e4m3 codes' bf16 values), the head's rows into the
// (kHeadOutputs, n) output.
struct WgProbeIo {
  static constexpr bool kFeatures = true;
  const void* feats;
  int rows, n;
  float* out;
  template <class Ch>
  PT_HD void put(unsigned char* feat, int row, int k, int p) const {
    const uint8_t* const codes = (const uint8_t*)feats;
    if constexpr (Ch::kInt8)
      feat[wg_offset<1>(row, k)] = p < n ? codes[(size_t)k * n + p] : 0;
    else if constexpr (Ch::kNarrow)
      *reinterpret_cast<uint16_t*>(feat + wg_offset<2>(row, k)) =
          p < n ? (uint16_t)e4m3_to_bf16(codes[(size_t)k * n + p]) : (uint16_t)0;
    else
      *reinterpret_cast<uint16_t*>(feat + wg_offset<2>(row, k)) =
          f32_to_bf16(p < n ? ((const float*)feats)[(size_t)k * n + p] : 0.0f);
  }
  PT_HD void store(int o, int p, float y) const { out[(size_t)o * n + p] = y; }
};

template <int V>
using K8Chain = typename std::conditional<
    V == kBf16, ChainBf16,
    typename std::conditional<(V < kFp8), ChainK8<V>, ChainK8Wide<V>>::type>::type;

template <int V>
__global__ void __launch_bounds__(kWgThreads, 1) quant_probe_wg_kernel(NifWg net,
                                                                     const void* __restrict__ feats,
                                                                     int rows, int n,
                                                                     float* __restrict__ out) {
  nif_wg_tiles<K8Chain<V>>(net, WgProbeIo{feats, rows, n, out});
}

template <int V>
int launch_quant_probe_wg(const NifWg& net, const void* feats, int rows, int n, float* out,
                          void* stream) {
  using Chain = K8Chain<V>;
  void (*const kernel)(NifWg, const void*, int, int, float*) = quant_probe_wg_kernel<V>;
  if (Chain::kInt8 != (net.int8 != 0) || net.tf32 || (V != kBf16 && net.mult[0] == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_wg(kernel, net, n, stream, net, feats, rows, n, out);
}

}  // namespace pt

// variant: the index in probes/quant.py::VARIANTS (bf16, int8_requant,
// int8_perchan, int8_raw, fp8_e4m3, fp8_raw); wg the variant's wgmma chain
// (bf16 slices; the 8-bit slices of the int8 codes; the bf16 slices of the
// e4m3 codes' values) and rows the feature rows of feats.
extern "C" int pt_quant_probe(const pt::NifWg* wg, int variant, const void* feats, int rows,
                              int n, float* out, void* stream) {
  if (wg == nullptr) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case pt::kBf16: return pt::launch_quant_probe_wg<pt::kBf16>(*wg, feats, rows, n, out, stream);
    case pt::kInt8Requant:
      return pt::launch_quant_probe_wg<pt::kInt8Requant>(*wg, feats, rows, n, out, stream);
    case pt::kInt8Perchan:
      return pt::launch_quant_probe_wg<pt::kInt8Perchan>(*wg, feats, rows, n, out, stream);
    case pt::kInt8Raw:
      return pt::launch_quant_probe_wg<pt::kInt8Raw>(*wg, feats, rows, n, out, stream);
    case pt::kFp8: return pt::launch_quant_probe_wg<pt::kFp8>(*wg, feats, rows, n, out, stream);
    case pt::kFp8Raw:
      return pt::launch_quant_probe_wg<pt::kFp8Raw>(*wg, feats, rows, n, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
