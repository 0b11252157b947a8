// Device code of the NIF env light: equirect (u, v) of an escaped ray,
// the Fourier encode, the layer chain on the tensor cores - bf16 with f32
// accumulation (nif_tile) or int8 with int32 accumulation (nif_tile_int8)
// - and the f32 decode, for a tile of kTile rays run by a block of
// kThreads threads.  The bf16 chain here (mma.sync) serves the probes K6
// (probes.cu) and K8's bf16 variant (quant_probe.cu), the yardsticks of
// the old chain; K2, K3 and K4 (nif.cu, megastep.cuh) run their bf16 chain
// on wgmma (nif_wgmma.cuh) and their int8 chain here.
//
// What bounds it: the chain is ~0.54 M multiply-adds per ray for the
// canonical 6x320 net (1.2 TFLOP per 1104x1000 sample), and its 1.09 MB of
// bf16 weights (0.55 MB as int8) do not fit in one SM's shared memory as
// they fit in the TPU's VMEM.  So the weights stream layer by layer from
// device memory, where they stay resident in the 50 MB L2, and every
// block reuses each weight it loads for the kTile rays of its tile.
//
// bf16 chain: mma.sync m16n8k16, f32 accumulators; a layer is
// D[ray][out] = X^T[ray][in] * W[in][out]; the activations X live in shared
// memory as bf16, feature-major ([feature][ray], rows padded to kTileP so
// ldmatrix.trans reads them without bank conflicts) in two ping-pong
// buffers sized from the widest layer, and the weights arrive as B
// fragments straight from L2 in a layout packed on the host
// (ops/nif.py::kernel_operands: (out, in) rows, K zero-padded to 16).
// Each warp owns up to kQMax 8-wide output tiles across all 64 rays, so
// one A fragment feeds kQMax MMAs.  The Fourier features have a buffer of
// their own, which the skip layer reads as the tail of its K dimension
// (the reference's concat(trunk, feats)).
//
// int8 chain (K5, replaces ops/nif_pallas.py::_quant_mlp_core; the
// arithmetic is models/quant.quant_layer_t): mma.sync m16n8k32 s8 x s8 ->
// s32.  There is no 8-bit ldmatrix.trans, and the s8 A fragment wants K
// contiguous per ray, so int8 activations are ray-major ([ray][k], rows of
// round32(width) + 16 bytes, an odd multiple of 16, so the 8 rows of an
// ldmatrix phase hit 8 distinct bank groups) and plain ldmatrix yields
// the A fragments.  Weights are (out, in) int8 rows with K padded to 32
// (ops/nif.py::quant_kernel_operands).  The epilogue runs in f32 in the
// reference's order - y = acc * mult (+ accf * mult_skip) + bias, ReLU,
// clip(rint(y * inv_next) - 128, -128, 127) - and, with --fmad=false,
// rounds where the plain version rounds.  The skip layer's trunk and
// feature dots need separate accumulators (two multipliers), so it runs
// kQSkip output tiles per warp and pass instead of kQMax.  The precision
// probe's fp8 chain (csrc/quant_probe.cu) reuses that layout and those
// fragments with e4m3 codes (mma_rows_e4m3).
//
// The encode uses sincosf on the direct angles 2^j * 2 (u - 1) (exact in
// f32), like the trainer's models/nif.fourier_features, instead of the TPU
// kernel's double-angle recurrence; acos/atan2 are the true functions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace pt {

constexpr int kNifMaxLayers = 16;
constexpr int kTile = 64;  // rays per NIF tile (4 MMA row tiles of 16)
constexpr int kTileP = kTile + 8;  // padded activation row (bf16 elements)
constexpr int kThreads = 256;  // threads per block of the NIF kernels
constexpr int kWarps = kThreads / 32;
constexpr int kMTiles = kTile / 16;
constexpr int kQMax = 5;  // 8-wide output tiles per warp and pass: 320 outputs in one pass
constexpr int kQSkip = 2;  // the same for the int8 skip layer (two accumulator sets)

// Mirrored by ops/_lib.py::NifNet (ctypes); keep the field order.
struct NifNet {
  int num_layers, embed_dim, max_width, log_flag;
  int int8;  // 1: the int8 chain (nif_tile_int8); 0: the bf16 chain (nif_tile)
  int fan_in[kNifMaxLayers], fan_out[kNifMaxLayers], skip[kNifMaxLayers];
  int k_trunk[kNifMaxLayers];  // trunk inputs rounded up to 16 (bf16) or 32 (int8)
  int k_pad[kNifMaxLayers];  // packed row length: k_trunk (+ features rounded likewise)
  const void* w[kNifMaxLayers];  // bf16 or int8 (round8(fan_out), k_pad), zero padded
  const float* b[kNifMaxLayers];  // f32 (fan_out,)
  const float* mult[kNifMaxLayers];  // int8: f32 (fan_out,) accumulator multipliers
  const float* mult_skip;  // int8: f32 multipliers of the skip layer's feature dot
  float inv_next[kNifMaxLayers];  // int8: requant steps 255 / a_l of the hidden layers
  float max_v;
  float mean[3];
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Row of ray-major int8 activations of `width` features, in bytes.
__host__ __device__ inline int row8(int width) { return ((width + 31) & ~31) + 16; }

PT_HD uint16_t f32_to_bf16(float x) {  // round to nearest even, NaN kept quiet
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return (uint16_t)((u >> 16) | 0x40u);
  return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

PT_HD uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

PT_HD void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

PT_HD void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

PT_HD void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

PT_HD void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e4m3 x e4m3 -> f32 (sm_89 and later).  The m16n8k32 A and B fragments
// of e4m3 are laid out as those of s8: four 8-bit values per register.
PT_HD void mma_e4m3(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory plan of one NIF tile (bytes, 16-byte aligned pieces).
struct NifSmem {
  size_t u, v, out, feat, buf0, buf1, total;
};

inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

inline NifSmem nif_smem_plan(const NifNet& net, size_t offset) {
  const size_t row = kTileP * sizeof(uint16_t);
  const size_t feat = net.int8 ? (size_t)kTile * row8(4 * net.embed_dim)
                               : round16(4 * net.embed_dim) * row;
  const size_t act = net.int8 ? (size_t)kTile * row8(net.max_width)
                              : round16(net.max_width) * row;
  NifSmem s;
  s.u = offset;
  s.v = s.u + align16(kTile * sizeof(float));
  s.out = s.v + align16(kTile * sizeof(float));
  s.feat = s.out + align16(3 * kTile * sizeof(float));
  s.buf0 = s.feat + align16(feat);
  s.buf1 = s.buf0 + align16(act);
  s.total = s.buf1 + align16(act);
  return s;
}

struct NifTile {
  float* u;  // [kTile]
  float* v;  // [kTile]
  float* out;  // [3][kTile] decoded network (bgr) order
  // bf16: [round16(4E)][kTileP] and [round16(max_width)][kTileP] feature-major;
  // int8: [kTile][row8(4E)] and [kTile][row8(max_width)] ray-major.
  unsigned char* feat;
  unsigned char* buf0;
  unsigned char* buf1;

  __device__ NifTile(unsigned char* smem, const NifSmem& s)
      : u((float*)(smem + s.u)),
        v((float*)(smem + s.v)),
        out((float*)(smem + s.out)),
        feat(smem + s.feat),
        buf0(smem + s.buf0),
        buf1(smem + s.buf1) {}
};

// Equirect (u, v) of an escape direction; non-escaped lanes (zero
// directions) map to (0, 0) like the reference's PreProcessEscapedRays.
PT_HD void equirect_uv(float dx, float dy, float dz, float azimuth, float* u, float* v) {
  const bool escaped = dx * dx + dy * dy + dz * dz > 0.5f;
  const float theta = acosf(fminf(fmaxf(dy, -1.0f), 1.0f));
  float phi = atan2f(dz, dx) + azimuth;
  phi = phi < 0.0f ? phi + kTwoPi : (phi > kTwoPi ? phi - kTwoPi : phi);
  *u = escaped ? theta * kInvPi : 0.0f;
  *v = escaped ? phi * kInvTwoPi : 0.0f;
}

// sin and cos of octave j of coordinate `coord`: angle 2^j * 2 (coord - 1).
PT_HD void fourier(float coord, int j, float* s, float* c) {
  sincosf((2.0f * (coord - 1.0f)) * (float)(1 << j), s, c);
}

// acc[q][mt] += X^T * W over `ksteps` K-steps of 16: A fragments from the
// feature-major activations x (ldmatrix.trans), B fragments from the
// packed weight rows at column k_off, for the warp's output tiles
// j0 + q * kWarps (q < kQMax, j < n_tiles).
PT_HD void mma_rows(float (&acc)[kQMax][kMTiles][4], const uint16_t* x, int ksteps,
                    const uint16_t* __restrict__ w, int k_pad, int k_off, int n_tiles, int j0,
                    int lane) {
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 4) & 1) * 8;  // ldmatrix row of this lane
  const int lcol = ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[kMTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
      ldmatrix_x4_trans(smem_u32(x + (ks * 16 + lrow) * kTileP + mt * 16 + lcol), a[mt]);
#pragma unroll
    for (int q = 0; q < kQMax; ++q) {
      const int j = j0 + q * kWarps;
      if (j < n_tiles) {
        const uint16_t* wr = w + (size_t)(j * 8 + g) * k_pad + k_off + ks * 16 + tg * 2;
        const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wr));
        const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wr + 8));
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) mma_bf16(acc[q][mt], a[mt], b0, b1);
      }
    }
  }
}

// Fourier features [sin u 2^j | sin v 2^j | cos u 2^j | cos v 2^j] of the
// tile's (u, v) into t.feat as bf16, then zero rows up to the next
// multiple of 16 (K padding); ends with a barrier.
__device__ inline void encode_bf16(const NifNet& net, const NifTile& t) {
  const int tid = threadIdx.x;
  const int E = net.embed_dim, feat_rows = 4 * E;
  uint16_t* const feat = (uint16_t*)t.feat;
  for (int idx = tid; idx < 2 * E * kTile; idx += kThreads) {
    const int r = idx % kTile, rest = idx / kTile;
    const int axis = rest & 1, j = rest >> 1;
    float s, c;
    fourier(axis ? t.v[r] : t.u[r], j, &s, &c);
    feat[(axis * E + j) * kTileP + r] = f32_to_bf16(s);
    feat[(2 * E + axis * E + j) * kTileP + r] = f32_to_bf16(c);
  }
  for (int idx = tid; idx < (round16(feat_rows) - feat_rows) * kTile; idx += kThreads)
    feat[(feat_rows + idx / kTile) * kTileP + idx % kTile] = 0;
  __syncthreads();
}

// Called after each layer's products and epilogue, before its barrier.
struct NoLayerHook {
  __device__ void operator()(int) const {}
};

// The bf16 layer chain and decode over the features in t.feat; leaves the
// decoded network-order output in t.out.  after_layer(l) runs in every
// thread after layer l (the overlap probes put ALU work there).  All
// kThreads threads of the block must call it; it ends with a barrier.
template <class AfterLayer>
__device__ inline void nif_layers(const NifNet& net, const NifTile& t, AfterLayer after_layer) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint16_t* const feat = (uint16_t*)t.feat;
  const int g = lane >> 2, tg = lane & 3;
  uint16_t* const buf0 = (uint16_t*)t.buf0;
  uint16_t* const buf1 = (uint16_t*)t.buf1;
  const uint16_t* in = feat;
  uint16_t* out = buf0;
  for (int l = 0; l < net.num_layers; ++l) {
    const int fan_out = net.fan_out[l], k_trunk = net.k_trunk[l], k_pad = net.k_pad[l];
    const uint16_t* w = (const uint16_t*)net.w[l];
    const bool last = l == net.num_layers - 1;
    const int n_tiles = (fan_out + 7) / 8;
    for (int j0 = warp; j0 < n_tiles; j0 += kQMax * kWarps) {
      float acc[kQMax][kMTiles][4] = {};
      mma_rows(acc, in, k_trunk / 16, w, k_pad, 0, n_tiles, j0, lane);
      if (net.skip[l])  // concat(trunk, feats): feature columns follow the trunk
        mma_rows(acc, feat, (k_pad - k_trunk) / 16, w, k_pad, k_trunk, n_tiles, j0, lane);
#pragma unroll
      for (int q = 0; q < kQMax; ++q) {
        const int j = j0 + q * kWarps;
        if (j >= n_tiles) continue;
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // C fragment: (ray g [+8], output 2 tg [+1])
            const int o = j * 8 + tg * 2 + (e & 1);
            const int ray = mt * 16 + g + (e >> 1) * 8;
            if (o >= fan_out) continue;
            const float y = acc[q][mt][e] + __ldg(net.b[l] + o);
            if (!last) {
              out[o * kTileP + ray] = f32_to_bf16(fmaxf(y, 0.0f));
            } else if (o < 3) {  // decode at f32: y * max + mean, exp if log
              const float z = y * net.max_v + net.mean[o];
              t.out[o * kTile + ray] = net.log_flag ? expf(z) : z;
            }
          }
      }
    }
    if (!last)  // zero the K padding rows the next layer reads
      for (int idx = tid; idx < (round16(fan_out) - fan_out) * kTile; idx += kThreads)
        out[(fan_out + idx / kTile) * kTileP + idx % kTile] = 0;
    after_layer(l);
    __syncthreads();
    in = out;
    out = out == buf0 ? buf1 : buf0;
  }
}

// Encode -> bf16 layer chain -> decode for the rays whose (u, v) are in
// t.u / t.v; leaves the decoded network-order output in t.out.  All
// kThreads threads of the block must call it; it ends with a barrier.
__device__ inline void nif_tile(const NifNet& net, const NifTile& t) {
  encode_bf16(net, t);
  nif_layers(net, t, NoLayerHook{});
}

// acc[q][mt] += X[ray][k] * W[out][k] over `ksteps` K-steps of 32: A
// fragments from the ray-major int8 activations x (rows of `stride`
// bytes; plain ldmatrix: matrix i of the x4 is rays +8 (i & 1), K bytes
// +16 (i >> 1), exactly the s8 A fragment a0..a3), B fragments from the
// packed int8 weight rows at column k_off, for the warp's output tiles
// j0 + q * kWarps (q < Q, j < n_tiles).
template <int Q>
PT_HD void mma_rows_s8(int (&acc)[Q][kMTiles][4], const int8_t* x, int stride, int ksteps,
                       const int8_t* __restrict__ w, int k_pad, int k_off, int n_tiles, int j0,
                       int lane) {
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row of this lane
  const int lcol = (lane >> 4) * 16;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[kMTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
      ldmatrix_x4(smem_u32(x + (mt * 16 + lrow) * stride + ks * 32 + lcol), a[mt]);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = j0 + q * kWarps;
      if (j < n_tiles) {
        const int8_t* wr = w + (size_t)(j * 8 + g) * k_pad + k_off + ks * 32 + tg * 4;
        const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wr));
        const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wr + 16));
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) mma_s8(acc[q][mt], a[mt], b0, b1);
      }
    }
  }
}

// mma_rows_s8 with e4m3 codes and f32 accumulators: the same fragments
// from the same ray-major layout (plain ldmatrix), the e4m3 MMA.
template <int Q>
PT_HD void mma_rows_e4m3(float (&acc)[Q][kMTiles][4], const uint8_t* x, int stride, int ksteps,
                         const uint8_t* __restrict__ w, int k_pad, int k_off, int n_tiles, int j0,
                         int lane) {
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row of this lane
  const int lcol = (lane >> 4) * 16;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[kMTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
      ldmatrix_x4(smem_u32(x + (mt * 16 + lrow) * stride + ks * 32 + lcol), a[mt]);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = j0 + q * kWarps;
      if (j < n_tiles) {
        const uint8_t* wr = w + (size_t)(j * 8 + g) * k_pad + k_off + ks * 32 + tg * 4;
        const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wr));
        const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wr + 16));
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) mma_e4m3(acc[q][mt], a[mt], b0, b1);
      }
    }
  }
}

// One pass of int8 layer l over the warp's output tiles j0 + q * kWarps:
// the dots, then y = acc * mult (+ accf * mult_skip) + bias in f32; a
// hidden layer writes ReLU and the asymmetric requant as int8 codes
// out[ray][o], the head decodes into t.out.
template <int Q, bool kSkip>
__device__ inline void int8_layer_pass(const NifNet& net, int l, const NifTile& t,
                                       const int8_t* in, int in_stride, const int8_t* feat,
                                       int feat_stride, int8_t* out, int out_stride, int j0,
                                       int lane) {
  const int fan_out = net.fan_out[l], k_trunk = net.k_trunk[l], k_pad = net.k_pad[l];
  const int n_tiles = (fan_out + 7) / 8;
  const bool last = l == net.num_layers - 1;
  const int8_t* w = (const int8_t*)net.w[l];
  int acc[Q][kMTiles][4] = {};
  int accf[kSkip ? Q : 1][kMTiles][4] = {};
  mma_rows_s8<Q>(acc, in, in_stride, k_trunk / 32, w, k_pad, 0, n_tiles, j0, lane);
  if constexpr (kSkip)  // the feature columns: a dot of their own
    mma_rows_s8<Q>(accf, feat, feat_stride, (k_pad - k_trunk) / 32, w, k_pad, k_trunk,
                   n_tiles, j0, lane);
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
        float y = (float)acc[q][mt][e] * __ldg(net.mult[l] + o);
        if constexpr (kSkip) y = y + (float)accf[q][mt][e] * __ldg(net.mult_skip + o);
        y = y + __ldg(net.b[l] + o);
        if (!last) {  // [0, a_l] onto [-128, 127]; the +128 is folded into the next bias
          const float r = rintf(fmaxf(y, 0.0f) * inv) - 128.0f;
          out[ray * out_stride + o] = (int8_t)(int)fminf(fmaxf(r, -128.0f), 127.0f);
        } else if (o < 3) {  // decode at f32: y * max + mean, exp if log
          const float z = y * net.max_v + net.mean[o];
          t.out[o * kTile + ray] = net.log_flag ? expf(z) : z;
        }
      }
  }
}

// Fourier features of the tile's (u, v) into t.feat as int8 codes on the
// constant 1/127 grid, clip(rint(f * 127), -127, 127), ray-major; ends
// with a barrier.
__device__ inline void encode_int8(const NifNet& net, const NifTile& t) {
  const int tid = threadIdx.x;
  const int E = net.embed_dim;
  const int fs = row8(4 * E);
  int8_t* const feat = (int8_t*)t.feat;
  for (int idx = tid; idx < 2 * E * kTile; idx += kThreads) {
    const int r = idx % kTile, rest = idx / kTile;
    const int axis = rest & 1, j = rest >> 1;
    float s, c;
    fourier(axis ? t.v[r] : t.u[r], j, &s, &c);
    feat[r * fs + axis * E + j] = (int8_t)(int)fminf(fmaxf(rintf(s * 127.0f), -127.0f), 127.0f);
    feat[r * fs + 2 * E + axis * E + j] =
        (int8_t)(int)fminf(fmaxf(rintf(c * 127.0f), -127.0f), 127.0f);
  }
  __syncthreads();
}

// Encode -> int8 layer chain -> decode, as nif_tile.  K padding columns of
// the int8 activations are never written: the packed weights are zero
// there, and an integer product with zero is zero whatever the byte holds.
__device__ inline void nif_tile_int8(const NifNet& net, const NifTile& t) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fs = row8(4 * net.embed_dim), as = row8(net.max_width);
  int8_t* const feat = (int8_t*)t.feat;
  encode_int8(net, t);

  int8_t* const buf0 = (int8_t*)t.buf0;
  int8_t* const buf1 = (int8_t*)t.buf1;
  const int8_t* in = feat;
  int in_stride = fs;
  int8_t* out = buf0;
  for (int l = 0; l < net.num_layers; ++l) {
    const int n_tiles = (net.fan_out[l] + 7) / 8;
    if (net.skip[l]) {
      for (int j0 = warp; j0 < n_tiles; j0 += kQSkip * kWarps)
        int8_layer_pass<kQSkip, true>(net, l, t, in, in_stride, feat, fs, out, as, j0, lane);
    } else {
      for (int j0 = warp; j0 < n_tiles; j0 += kQMax * kWarps)
        int8_layer_pass<kQMax, false>(net, l, t, in, in_stride, feat, fs, out, as, j0, lane);
    }
    __syncthreads();
    in = out;
    in_stride = as;
    out = out == buf0 ? buf1 : buf0;
  }
}

// The chain of a tile in the precision the kernel was instantiated for.
template <bool kInt8>
__device__ inline void nif_chain(const NifNet& net, const NifTile& t) {
  if constexpr (kInt8)
    nif_tile_int8(net, t);
  else
    nif_tile(net, t);
}

// Measurement stub of the chain (ops/megastep_pallas.py::_stub_nif_layer):
// the encode runs as in the real chain, then every layer's product is
// replaced by ones, with no bias, and the head decodes those ones.  Each
// layer's ones are x * 0 + 1 of the layer before, from the first feature
// on, as the reference's x[:1] * 0.0 + 1.0: without fast-math (and with
// --fmad=false) nvcc cannot fold x * 0 (x may be inf or NaN), so the
// encode stays live.  Ends with a barrier, as nif_chain.
template <bool kInt8>
__device__ inline void nif_chain_stub(const NifNet& net, const NifTile& t) {
  const int tid = threadIdx.x;
  float x = 0.0f;
  if constexpr (kInt8) {
    encode_int8(net, t);
    if (tid < kTile) x = (float)((const int8_t*)t.feat)[tid * row8(4 * net.embed_dim)];
  } else {
    encode_bf16(net, t);
    if (tid < kTile) x = __uint_as_float((uint32_t)((const uint16_t*)t.feat)[tid] << 16);
  }
  if (tid < kTile) {
    for (int l = 0; l < net.num_layers; ++l) x = x * 0.0f + 1.0f;
#pragma unroll
    for (int o = 0; o < 3; ++o) {  // decode at f32: y * max + mean, exp if log
      const float z = x * net.max_v + net.mean[o];
      t.out[o * kTile + tid] = net.log_flag ? expf(z) : z;
    }
  }
  __syncthreads();
}

}  // namespace pt
