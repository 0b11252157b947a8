// K2: escaped-ray env shade - equirect (u, v), NIF chain, bgr -> rgb flip
// and the escape weights, for the rays of one trace sample.
// K4: the NIF at given (u, v) -> (3, P) f32 in network channel order.
//
// Replace ipu_path_trace_tpu/ops/nif_pallas.py::nif_env_shade_pallas
// (kernel body _env_shade_kernel, :307) and ::nif_apply_pallas_t (kernel
// body _kernel, :287).  Each kernel has two instantiations:
//  * <false>, the bf16 chain: nif_wgmma.cuh (wgmma on weights streamed
//    through shared memory by bulk copies), 128-ray tiles, a persistent
//    block of kWgThreads threads per SM, operands in NifWg;
//  * <true>, the int8 chain (K5): a block of pt::kThreads threads per tile
//    of pt::kTile rays, nif_dev.cuh::nif_tile_int8 (mma.sync s8), operands
//    in NifNet.
// The launchers pick by which operands they are given; a bf16 NifNet is
// refused (its mma.sync chain serves K3, K6 and K8 only).
#include "nif_dev.cuh"
#include "nif_wgmma.cuh"

namespace pt {

template <bool kInt8>
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
  nif_chain<kInt8>(net, t);
  if (tid < kTile && p < n) {
    out[p] = escw[p] * t.out[2 * kTile + tid];
    out[n + p] = escw[n + p] * t.out[kTile + tid];
    out[2 * n + p] = escw[2 * n + p] * t.out[tid];
  }
}

template <bool kInt8>
__global__ void __launch_bounds__(kWgThreads, 1) env_shade_kernel(NifWg net,
                                                                const float* __restrict__ escd,
                                                                const float* __restrict__ escw,
                                                                float azimuth, int n,
                                                                float* __restrict__ out) {
  static_assert(!kInt8, "the int8 chain takes the NifNet kernel");
  nif_wg_tiles(net, WgShadeIo{escd, escw, azimuth, n, out});
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 2) nif_apply_kernel(NifNet net, NifSmem plan,
                                                             const float* __restrict__ u,
                                                             const float* __restrict__ v, int n,
                                                             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NifTile t(smem, plan);
  const int tid = threadIdx.x;
  const int p = blockIdx.x * kTile + tid;
  if (tid < kTile) {
    t.u[tid] = p < n ? u[p] : 0.0f;
    t.v[tid] = p < n ? v[p] : 0.0f;
  }
  __syncthreads();
  nif_chain<kInt8>(net, t);
  if (tid < kTile && p < n) {
    out[p] = t.out[tid];
    out[n + p] = t.out[kTile + tid];
    out[2 * n + p] = t.out[2 * kTile + tid];
  }
}

template <bool kInt8>
__global__ void __launch_bounds__(kWgThreads, 1) nif_apply_kernel(NifWg net,
                                                                const float* __restrict__ u,
                                                                const float* __restrict__ v,
                                                                int n, float* __restrict__ out) {
  static_assert(!kInt8, "the int8 chain takes the NifNet kernel");
  nif_wg_tiles(net, WgApplyIo{u, v, n, out});
}

// Sets the kernel's dynamic shared memory, then launches one tile per block.
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, const NifSmem& plan, int n, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kTile - 1) / kTile;
  if (blocks == 0) return 0;
  kernel<<<blocks, kThreads, plan.total, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace pt

// Exactly one of net (an int8 model) and wg (a bf16 model) is given.
extern "C" int pt_env_shade(const pt::NifNet* net, const pt::NifWg* wg, const float* escd,
                            const float* escw, float azimuth, int n, float* out, void* stream) {
  if (wg != nullptr && net == nullptr) {
    void (*const kernel)(pt::NifWg, const float*, const float*, float, int, float*) =
        pt::env_shade_kernel<false>;
    return pt::launch_wg(kernel, *wg, n, stream, *wg, escd, escw, azimuth, n, out);
  }
  if (wg != nullptr || net == nullptr || !net->int8) return (int)cudaErrorInvalidValue;
  void (*const kernel)(pt::NifNet, pt::NifSmem, const float*, const float*, float, int, float*) =
      pt::env_shade_kernel<true>;
  const pt::NifSmem plan = pt::nif_smem_plan(*net, 0);
  return pt::launch_tiles(kernel, plan, n, stream, *net, plan, escd, escw, azimuth, n, out);
}

extern "C" int pt_nif_apply(const pt::NifNet* net, const pt::NifWg* wg, const float* u,
                            const float* v, int n, float* out, void* stream) {
  if (wg != nullptr && net == nullptr) {
    void (*const kernel)(pt::NifWg, const float*, const float*, int, float*) =
        pt::nif_apply_kernel<false>;
    return pt::launch_wg(kernel, *wg, n, stream, *wg, u, v, n, out);
  }
  if (wg != nullptr || net == nullptr || !net->int8) return (int)cudaErrorInvalidValue;
  void (*const kernel)(pt::NifNet, pt::NifSmem, const float*, const float*, int, float*) =
      pt::nif_apply_kernel<true>;
  const pt::NifSmem plan = pt::nif_smem_plan(*net, 0);
  return pt::launch_tiles(kernel, plan, n, stream, *net, plan, u, v, n, out);
}
