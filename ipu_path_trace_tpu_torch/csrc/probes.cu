// K6 and K7: the overlap probes - does the NIF chain on the tensor cores
// overlap independent ALU work in one kernel?
//
// Replace scripts/overlap_probe.py::build (k_mxu :55, k_vpu :62, k_both
// :67) and scripts/overlap_probe2.py::build (k_loop :53).  The matrix part
// is the probes' seven bias-free bf16 layers, packed as a NifModel with
// zero biases and a decode of y * 1 + 0, whose 48 feature rows all hold
// bf16(v) of the lane; the output is the head's row 0.  The ALU part is per
// thread: rounds of x = sin(x) * 1.1 + sqrt(|x| + 0.3), then
// x > 1 ? x / 2 : x + 1/4.
//
// Both run the bf16 wgmma chain of nif_wgmma.cuh (128-ray tiles, the
// weights streamed through shared memory: the NifWg of ops/nif.py's
// wg_struct).  Each lane's scalar work runs in the consumer thread that
// owns it: the first 64 threads of each consumer warpgroup (two whole
// warps), thread t owning row t of its group's 64 rows.
//
// probe_wg_kernel<false> (K6 'mxu'): the chain alone, output row 0 (k_mxu).
// probe_alu_kernel: `rounds` ALU rounds alone, one lane per thread (k_vpu).
// probe_wg_kernel<true> (K6 'both'): the chain with `per_layer` ALU rounds
//   after each layer's last wgmma is issued and before the wait for it
//   (the layer hook), so they overlap the layer's MMAs in flight (k_both);
//   output row 0 + the ALU value.
// probe_wg_loop_kernel<kPrng, kState> (K7): `iters` iterations of the
//   interleaved pair in the kernel (k_loop), each one pass of the chain
//   over the tile: the owning thread forms v = u + acc 1e-6 (with kPrng
//   plus the top 24 bits of a Philox4x32-10 word, key (7, 0), counter
//   (lane, iteration, 0, 0), csrc/common.cuh, times 1e-9), writes bf16(v)
//   into its row's features, runs the seven layers with `per_layer` ALU
//   rounds on v in the layer hook, reads row 0 of the head and updates acc
//   (r = v + row 0) and, with kState, twelve more carries in registers
//   (each one ALU round plus r 1e-9 per iteration); out = acc + the
//   carries' sum.  The producer streams the tile's slice sequence once per
//   iteration (wg_tiles' passes), so the weights run through the ring
//   `iters` times per tile while the carries stay in the owning threads.
//
// What bounds them: the chain kernels are bound by the tensor cores'
// multiply-adds (0.54 M per lane and pass, as K2: 1.2 TFLOP per pass at
// 1,105,920 lanes, so K7's 16 iterations are 16 times K6 'mxu''s work),
// the ALU kernel by the SFU's sin and sqrt (the f32 work is ~1% of one
// chain).  In K6 'both' and K7 the ALU rounds run while the layer's last
// MMAs are in flight (wgmma is asynchronous: the issuing threads go on);
// the probes measure how much of them that hides.
#include "nif_wgmma.cuh"

namespace pt {

PT_HD float alu_round(float x) {
  x = sinf(x) * 1.1f + sqrtf(fabsf(x) + 0.3f);
  return x > 1.0f ? x * 0.5f : x + 0.25f;
}

// K6's and K7's ALU rounds after each layer, in the consumer threads that
// own a lane (the first 64 of each warpgroup: two whole warps).
struct WgAluHook {
  float& v;
  int rounds;
  bool own;
  PT_HD void operator()(int) const {
    if (own)
      for (int k = 0; k < rounds; ++k) v = alu_round(v);
  }
};

// K6's and K7's head output: row 0 of ray p into shared memory
// (row0[p - ray0]), where the thread that owns the lane picks it up.
struct WgOverlapIo {
  int n, ray0;
  float* row0;
  PT_HD void store(int o, int p, float y) const {
    if (o == 0) row0[p - ray0] = y;
  }
};

template <bool kAlu>
__global__ void __launch_bounds__(kWgThreads, 1) probe_wg_kernel(NifWg net,
                                                               const float* __restrict__ u, int n,
                                                               int per_layer,
                                                               float* __restrict__ out) {
  wg_tiles<false>(net, (n + kWgRays - 1) / kWgRays, [&](WgConsumer& c, int tile) {
    const int ray0 = tile * kWgRays + 64 * c.wg;
    // Every feature row of ray p <- bf16(u[p]); the rows from 4E up stay
    // zero (wg_setup).
    unsigned char* const feat = c.smem + net.smem_feat;
    for (int idx = c.t; idx < 64 * 4 * net.embed_dim; idx += 128) {
      const int r = idx & 63, k = idx >> 6;
      *reinterpret_cast<uint16_t*>(feat + wg_offset<false>(64 * c.wg + r, k)) =
          f32_to_bf16(ray0 + r < n ? u[ray0 + r] : 0.0f);
    }
    fence_proxy_async();
    group_sync(c.wg);
    const bool own = c.t < 64;
    float v = own && ray0 + c.t < n ? u[ray0 + c.t] : 0.0f;
    float* const row0 = (float*)(c.smem + net.smem_uv) + 64 * c.wg;
    if constexpr (kAlu)
      wg_layers<ChainBf16>(net, c, ray0, WgOverlapIo{n, ray0, row0}, WgAluHook{v, per_layer, own});
    else
      wg_layers<ChainBf16>(net, c, ray0, WgOverlapIo{n, ray0, row0});
    group_sync(c.wg);  // row 0 of the group's rays stored
    if (own && ray0 + c.t < n) out[ray0 + c.t] = kAlu ? row0[c.t] + v : row0[c.t];
  });
}

__global__ void probe_alu_kernel(const float* __restrict__ u, int n, int rounds,
                                 float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float x = u[p];
  for (int k = 0; k < rounds; ++k) x = alu_round(x);
  out[p] = x;
}

constexpr int kProbeExtras = 12;

template <bool kPrng, bool kState>
__global__ void __launch_bounds__(kWgThreads, 1) probe_wg_loop_kernel(NifWg net,
                                                                    const float* __restrict__ u,
                                                                    int n, int per_layer,
                                                                    int iters,
                                                                    float* __restrict__ out) {
  wg_tiles<false>(
      net, (n + kWgRays - 1) / kWgRays,
      [&](WgConsumer& c, int tile) {
        const int ray0 = tile * kWgRays + 64 * c.wg, p = ray0 + c.t;
        const bool own = c.t < 64;
        const float u0 = own && p < n ? u[p] : 0.0f;
        constexpr int kExtras = kState ? kProbeExtras : 1;
        float extras[kExtras];
#pragma unroll
        for (int k = 0; k < kExtras; ++k) extras[k] = u0 * (float)(1.0 + 0.01 * k);
        float acc = 0.0f;
        unsigned char* const feat = c.smem + net.smem_feat;
        float* const row0 = (float*)(c.smem + net.smem_uv) + 64 * c.wg;
        for (int i = 0; i < iters; ++i) {
          float v = 0.0f;
          if (own) {  // row t of the group's features <- bf16(v); the rows from 4E up stay 0
            v = u0 + acc * 1e-6f;
            if constexpr (kPrng) {
              const U4 r = philox4x32_10(U4{(uint32_t)p, (uint32_t)i, 0u, 0u}, 7u, 0u);
              v = v + (float)(r.x >> 8) * 1e-9f;
            }
            const uint16_t b = f32_to_bf16(v);
            for (int k = 0; k < 4 * net.embed_dim; ++k)
              *reinterpret_cast<uint16_t*>(feat + wg_offset<false>(64 * c.wg + c.t, k)) = b;
          }
          fence_proxy_async();
          group_sync(c.wg);
          wg_layers<ChainBf16>(net, c, ray0, WgOverlapIo{n, ray0, row0},
                               WgAluHook{v, per_layer, own});
          group_sync(c.wg);  // row 0 of the group's rays stored
          if (own) {
            const float r = v + row0[c.t];
            if constexpr (kState) {
#pragma unroll
              for (int k = 0; k < kExtras; ++k) extras[k] = alu_round(extras[k]) + r * 1e-9f;
            }
            acc = acc + r;
          }
        }
        float sum = extras[0];
#pragma unroll
        for (int k = 1; k < kExtras; ++k) sum = sum + extras[k];
        if (own && p < n) out[p] = acc + sum;
      },
      iters);
}

}  // namespace pt

// K6 'mxu' and 'both' and K7 take the probe model's bf16 NifWg.
extern "C" int pt_probe_mxu(const pt::NifWg* wg, const float* u, int n, float* out,
                            void* stream) {
  if (wg == nullptr || wg->int8) return (int)cudaErrorInvalidValue;
  void (*const kernel)(pt::NifWg, const float*, int, int, float*) = pt::probe_wg_kernel<false>;
  return pt::launch_wg(kernel, *wg, n, stream, *wg, u, n, 0, out);
}

extern "C" int pt_probe_alu(const float* u, int n, int rounds, float* out, void* stream) {
  const int threads = 256, blocks = (n + threads - 1) / threads;
  if (blocks == 0) return 0;
  pt::probe_alu_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(u, n, rounds, out);
  return (int)cudaGetLastError();
}

extern "C" int pt_probe_both(const pt::NifWg* wg, const float* u, int n, int per_layer,
                             float* out, void* stream) {
  if (wg == nullptr || wg->int8) return (int)cudaErrorInvalidValue;
  void (*const kernel)(pt::NifWg, const float*, int, int, float*) = pt::probe_wg_kernel<true>;
  return pt::launch_wg(kernel, *wg, n, stream, *wg, u, n, per_layer, out);
}

extern "C" int pt_probe_loop(const pt::NifWg* wg, const float* u, int n, int per_layer,
                             int iters, int prng, int state, float* out, void* stream) {
  if (wg == nullptr || wg->int8 || iters < 0) return (int)cudaErrorInvalidValue;
  void (*const kernel)(pt::NifWg, const float*, int, int, int, float*) =
      prng ? (state ? pt::probe_wg_loop_kernel<true, true> : pt::probe_wg_loop_kernel<true, false>)
           : (state ? pt::probe_wg_loop_kernel<false, true>
                    : pt::probe_wg_loop_kernel<false, false>);
  return pt::launch_wg(kernel, *wg, n, stream, *wg, u, n, per_layer, iters, out);
}
