// K6 and K7: the overlap probes - does the NIF chain on the tensor cores
// overlap independent ALU work in one kernel?
//
// Replace scripts/overlap_probe.py::build (k_mxu :55, k_vpu :62, k_both
// :67) and scripts/overlap_probe2.py::build (k_loop :53).  The matrix part
// is the chain K3 runs (nif_dev.cuh::nif_layers: 64-ray tiles, bf16
// mma.sync from mma_rows, the skip layer's concat of the features) over
// the probes' seven bias-free layers, packed as a NifModel with zero biases
// and a decode of y * 1 + 0 (ops/nif.py::net_struct), whose 48 feature
// rows all hold bf16(v) of the lane.  The ALU part is per thread: rounds
// of x = sin(x) * 1.1 + sqrt(|x| + 0.3), then x > 1 ? x / 2 : x + 1/4.
//
// probe_mxu_kernel: the chain alone, output row 0 (k_mxu).
// probe_alu_kernel: `rounds` ALU rounds alone, one lane per thread (k_vpu).
// probe_both_kernel: the chain with `per_layer` ALU rounds for the tile's
//   lanes after each layer (k_both), output row 0 + the ALU value.
// probe_loop_kernel<kPrng, kState>: `iters` iterations of the interleaved
//   chain in the kernel (k_loop): v = u + acc 1e-6, with kPrng plus the top
//   24 bits of a Philox4x32-10 word (key (7, 0), counter (lane, iteration,
//   0, 0), csrc/common.cuh; four words per lane and iteration) times 1e-9,
//   with kState twelve more carries, each one ALU round plus r 1e-9 per
//   iteration; out = acc + the carries' sum.
//
// What bounds them: the chain kernels are bound by the tensor cores'
// multiply-adds (0.54 M per lane, as K2: 1.2 TFLOP per call at 1,105,920
// lanes), the ALU kernel by the SFU's sin and sqrt (the f32 work is ~1%
// of one chain).  Each ALU lane runs on one thread of the tile's first
// two warps while all eight warps share the products, so ALU and tensor
// work can overlap across the warps of a block and across the blocks of
// an SM; the probe measures how much does.
#include "nif_dev.cuh"

namespace pt {

PT_HD float alu_round(float x) {
  x = sinf(x) * 1.1f + sqrtf(fabsf(x) + 0.3f);
  return x > 1.0f ? x * 0.5f : x + 0.25f;
}

// Every feature row of lane `tid` (< kTile) <- bf16(v); K padding rows 0.
__device__ inline void fill_features(const NifNet& net, const NifTile& t, float v) {
  const int tid = threadIdx.x;
  uint16_t* const feat = (uint16_t*)t.feat;
  const int rows = 4 * net.embed_dim;
  const uint16_t b = f32_to_bf16(v);
  for (int r = 0; r < round16(rows); ++r) feat[r * kTileP + tid] = r < rows ? b : (uint16_t)0;
}

// The tile's ALU rounds after each layer, in the threads that own a lane.
struct AluHook {
  float& v;
  int rounds;
  __device__ void operator()(int) const {
    if (threadIdx.x < kTile)
      for (int k = 0; k < rounds; ++k) v = alu_round(v);
  }
};

__global__ void __launch_bounds__(kThreads, 2) probe_mxu_kernel(NifNet net, NifSmem plan,
                                                             const float* __restrict__ u, int n,
                                                             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NifTile t(smem, plan);
  const int tid = threadIdx.x, p = blockIdx.x * kTile + tid;
  if (tid < kTile) fill_features(net, t, p < n ? u[p] : 0.0f);
  __syncthreads();
  nif_layers(net, t, NoLayerHook{});
  if (tid < kTile && p < n) out[p] = t.out[tid];
}

__global__ void probe_alu_kernel(const float* __restrict__ u, int n, int rounds,
                                 float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float x = u[p];
  for (int k = 0; k < rounds; ++k) x = alu_round(x);
  out[p] = x;
}

__global__ void __launch_bounds__(kThreads, 2) probe_both_kernel(NifNet net, NifSmem plan,
                                                              const float* __restrict__ u, int n,
                                                              int per_layer,
                                                              float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NifTile t(smem, plan);
  const int tid = threadIdx.x, p = blockIdx.x * kTile + tid;
  float v = tid < kTile && p < n ? u[p] : 0.0f;
  if (tid < kTile) fill_features(net, t, v);
  __syncthreads();
  nif_layers(net, t, AluHook{v, per_layer});
  if (tid < kTile && p < n) out[p] = t.out[tid] + v;
}

constexpr int kProbeExtras = 12;

template <bool kPrng, bool kState>
__global__ void __launch_bounds__(kThreads, 2) probe_loop_kernel(NifNet net, NifSmem plan,
                                                              const float* __restrict__ u, int n,
                                                              int per_layer, int iters,
                                                              float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NifTile t(smem, plan);
  const int tid = threadIdx.x, p = blockIdx.x * kTile + tid;
  const float u0 = tid < kTile && p < n ? u[p] : 0.0f;
  constexpr int kExtras = kState ? kProbeExtras : 1;
  float extras[kExtras];
#pragma unroll
  for (int k = 0; k < kExtras; ++k) extras[k] = u0 * (float)(1.0 + 0.01 * k);
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) {
    float v = 0.0f;
    if (tid < kTile) {
      v = u0 + acc * 1e-6f;
      if constexpr (kPrng) {
        const U4 r = philox4x32_10(U4{(uint32_t)p, (uint32_t)i, 0u, 0u}, 7u, 0u);
        v = v + (float)(r.x >> 8) * 1e-9f;
      }
      fill_features(net, t, v);
    }
    __syncthreads();
    nif_layers(net, t, AluHook{v, per_layer});  // ends with a barrier
    if (tid < kTile) {
      const float r = v + t.out[tid];
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
  if (tid < kTile && p < n) out[p] = acc + sum;
}

template <typename Kernel, typename... Args>
int launch_probe(Kernel kernel, const NifNet& net, int n, void* stream, Args... args) {
  if (net.int8) return (int)cudaErrorInvalidValue;  // the probes run the bf16 chain
  const NifSmem plan = nif_smem_plan(net, 0);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kTile - 1) / kTile;
  if (blocks == 0) return 0;
  kernel<<<blocks, kThreads, plan.total, (cudaStream_t)stream>>>(net, plan, args...);
  return (int)cudaGetLastError();
}

}  // namespace pt

extern "C" int pt_probe_mxu(const pt::NifNet* net, const float* u, int n, float* out,
                            void* stream) {
  return pt::launch_probe(pt::probe_mxu_kernel, *net, n, stream, u, n, out);
}

extern "C" int pt_probe_alu(const float* u, int n, int rounds, float* out, void* stream) {
  const int threads = 256, blocks = (n + threads - 1) / threads;
  if (blocks == 0) return 0;
  pt::probe_alu_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(u, n, rounds, out);
  return (int)cudaGetLastError();
}

extern "C" int pt_probe_both(const pt::NifNet* net, const float* u, int n, int per_layer,
                             float* out, void* stream) {
  return pt::launch_probe(pt::probe_both_kernel, *net, n, stream, u, n, per_layer, out);
}

extern "C" int pt_probe_loop(const pt::NifNet* net, const float* u, int n, int per_layer,
                             int iters, int prng, int state, float* out, void* stream) {
  if (prng && state)
    return pt::launch_probe(pt::probe_loop_kernel<true, true>, *net, n, stream, u, n,
                            per_layer, iters, out);
  if (prng)
    return pt::launch_probe(pt::probe_loop_kernel<true, false>, *net, n, stream, u, n,
                            per_layer, iters, out);
  if (state)
    return pt::launch_probe(pt::probe_loop_kernel<false, true>, *net, n, stream, u, n,
                            per_layer, iters, out);
  return pt::launch_probe(pt::probe_loop_kernel<false, false>, *net, n, stream, u, n, per_layer,
                          iters, out);
}
