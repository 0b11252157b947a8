// K2: escaped-ray env shade - equirect (u, v), NIF chain, bgr -> rgb flip
// and the escape weights, for the rays of one trace sample.
//
// Replaces ipu_path_trace_tpu/ops/nif_pallas.py::nif_env_shade_pallas
// (kernel body _env_shade_kernel, :307).  A block of pt::kThreads threads
// shades a tile of pt::kTile rays; nif_dev.cuh says what bounds the chain
// and how the weights stream from L2.
#include "nif_dev.cuh"

namespace pt {

__global__ void __launch_bounds__(kThreads, 2) env_shade_kernel(NifNet net, NifSmem plan,
                                                             const float* __restrict__ escd,
                                                             const float* __restrict__ escw,
                                                             float azimuth, int n,
                                                             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NifTile t(smem, plan);
  const int tid = threadIdx.x;
  const int p = blockIdx.x * kTile + tid;
  if (tid < kTile) {
    float u = 0.0f, v = 0.0f;
    if (p < n) equirect_uv(escd[p], escd[n + p], escd[2 * n + p], azimuth, &u, &v);
    t.u[tid] = u;
    t.v[tid] = v;
  }
  __syncthreads();
  nif_tile(net, t);
  if (tid < kTile && p < n) {
    out[p] = escw[p] * t.out[2 * kTile + tid];
    out[n + p] = escw[n + p] * t.out[kTile + tid];
    out[2 * n + p] = escw[2 * n + p] * t.out[tid];
  }
}

}  // namespace pt

extern "C" int pt_env_shade(const pt::NifNet* net, const float* escd, const float* escw,
                            float azimuth, int n, float* out, void* stream) {
  const pt::NifSmem plan = pt::nif_smem_plan(*net, 0);
  cudaError_t err = cudaFuncSetAttribute(pt::env_shade_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + pt::kTile - 1) / pt::kTile;
  if (blocks == 0) return 0;
  pt::env_shade_kernel<<<blocks, pt::kThreads, plan.total, (cudaStream_t)stream>>>(
      *net, plan, escd, escw, azimuth, n, out);
  return (int)cudaGetLastError();
}
