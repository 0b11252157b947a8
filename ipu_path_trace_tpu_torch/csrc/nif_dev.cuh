// Device code of the NIF env light: equirect (u, v) of an escaped ray,
// the Fourier encode's angles, and the one mma.sync chain that remains:
// the bf16 layer chain (nif_layers, f32 accumulation) of the loop probe K7
// (probes.cu), for a tile of kTile rays run by a block of kThreads threads.
// Every other chain - K2, K3, K4, K6 and K8 in all their variants - runs on
// wgmma (nif_wgmma.cuh).
//
// What bounds it: the chain is ~0.54 M multiply-adds per ray for the
// canonical 6x320 net (1.2 TFLOP per 1104x1000 sample), and its 1.09 MB of
// bf16 weights do not fit in one SM's shared memory as they fit in the
// TPU's VMEM.  So the weights stream layer by layer from device memory,
// where they stay resident in the 50 MB L2, and every block reuses each
// weight it loads for the kTile rays of its tile.
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

// Mirrored by ops/_lib.py::NifNet (ctypes); keep the field order.
struct NifNet {
  int num_layers, embed_dim, max_width, log_flag;
  int fan_in[kNifMaxLayers], fan_out[kNifMaxLayers], skip[kNifMaxLayers];
  int k_trunk[kNifMaxLayers];  // trunk inputs rounded up to 16
  int k_pad[kNifMaxLayers];  // packed row length: k_trunk (+ features rounded likewise)
  const void* w[kNifMaxLayers];  // bf16 (round8(fan_out), k_pad), zero padded
  const float* b[kNifMaxLayers];  // f32 (fan_out,)
  float max_v;
  float mean[3];
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

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

PT_HD void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
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
  const size_t feat = round16(4 * net.embed_dim) * row;
  const size_t act = round16(net.max_width) * row;
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
  // bf16 [round16(4E)][kTileP] and [round16(max_width)][kTileP], feature-major
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

}  // namespace pt
