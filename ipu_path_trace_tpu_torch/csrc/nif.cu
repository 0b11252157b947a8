// K2: escaped-ray env shade - equirect (u, v), NIF chain, bgr -> rgb flip
// and the escape weights, for the rays of one trace sample.
// K4: the NIF at given (u, v) -> (3, P) f32 in network channel order.
//
// Replace ipu_path_trace_tpu/ops/nif_pallas.py::nif_env_shade_pallas
// (kernel body _env_shade_kernel, :307) and ::nif_apply_pallas_t (kernel
// body _kernel, :287).  Each kernel runs the wgmma chain of nif_wgmma.cuh
// (128-ray tiles, a persistent block of kWgThreads threads per SM, the
// weights streamed through shared memory by bulk copies) in one of two
// instantiations: <false> the bf16 chain, <true> the int8 chain (K5, the
// s8 slices; the reference's quant branch).  The launchers take a NifWg
// and pick the instantiation by its int8 flag; there is no other chain.
#include "nif_wgmma.cuh"

namespace pt {

template <bool kInt8>
__global__ void __launch_bounds__(kWgThreads, 1) env_shade_kernel(NifWg net,
                                                                const float* __restrict__ escd,
                                                                const float* __restrict__ escw,
                                                                float azimuth, int n,
                                                                float* __restrict__ out) {
  nif_wg_tiles<NifChain<kInt8>>(net, WgShadeIo{escd, escw, azimuth, n, out});
}

template <bool kInt8>
__global__ void __launch_bounds__(kWgThreads, 1) nif_apply_kernel(NifWg net,
                                                                const float* __restrict__ u,
                                                                const float* __restrict__ v,
                                                                int n, float* __restrict__ out) {
  nif_wg_tiles<NifChain<kInt8>>(net, WgApplyIo{u, v, n, out});
}

}  // namespace pt

extern "C" int pt_env_shade(const pt::NifWg* wg, const float* escd, const float* escw,
                            float azimuth, int n, float* out, void* stream) {
  if (wg == nullptr) return (int)cudaErrorInvalidValue;
  void (*const kernel)(pt::NifWg, const float*, const float*, float, int, float*) =
      wg->int8 ? pt::env_shade_kernel<true> : pt::env_shade_kernel<false>;
  return pt::launch_wg(kernel, *wg, n, stream, *wg, escd, escw, azimuth, n, out);
}

extern "C" int pt_nif_apply(const pt::NifWg* wg, const float* u, const float* v, int n,
                            float* out, void* stream) {
  if (wg == nullptr) return (int)cudaErrorInvalidValue;
  void (*const kernel)(pt::NifWg, const float*, const float*, int, float*) =
      wg->int8 ? pt::nif_apply_kernel<true> : pt::nif_apply_kernel<false>;
  return pt::launch_wg(kernel, *wg, n, stream, *wg, u, v, n, out);
}
