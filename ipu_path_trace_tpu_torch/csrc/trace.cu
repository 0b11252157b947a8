// K1: one sample per pixel through the whole bounce loop, in hardware
// (Philox), host-noise or Owen-Sobol mode (csrc/common.cuh).
//
// Replaces ipu_path_trace_tpu/ops/trace_pallas.py::trace_sample_pallas
// (kernel body _kernel, :408).  One thread owns one ray for all of its
// bounces, with every piece of per-ray state in registers; the scene
// tables (12 f32 per sphere, 15 per disc) sit in shared memory.
//
// What bounds it: arithmetic and divergence, not memory - a ray reads
// its pixel and (in host-noise mode) 4 + 4L noise floats and writes 11
// words, while it spends a few hundred flops per bounce on the
// intersection chain and the BSDF.  Rays of a warp leave the loop at
// different bounces (most escape on the first); the TPU hid that behind
// two block-wide lax.cond early-outs, here a warp simply retires once its
// last ray is done.  The ragged tail of the batch is masked in the kernel,
// so the host never pads.
#include "common.cuh"

namespace pt {

template <int kRng>
__global__ void __launch_bounds__(256) trace_kernel(TraceParams prm, const float* __restrict__ sph_g,
                                                    const float* __restrict__ dsc_g,
                                                    const float* __restrict__ cols,
                                                    const float* __restrict__ rows,
                                                    const float* __restrict__ noise,
                                                    const int* __restrict__ pid,
                                                    const int* __restrict__ base,
                                                    int sample_idx, int n, float* __restrict__ rad,
                                                    float* __restrict__ escd,
                                                    float* __restrict__ escw,
                                                    int* __restrict__ escm,
                                                    int* __restrict__ plen) {
  extern __shared__ float s_tables[];
  load_tables(prm, sph_g, dsc_g, s_tables);
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float* sph = s_tables;
  const float* dsc = s_tables + prm.num_s * kSphereF;
  TraceResult r;
  if constexpr (kRng == kRngHost)
    r = trace_ray(prm, sph, dsc, cols[p], rows[p], HostNoise{noise + p, (long long)n});
  else if constexpr (kRng == kRngSobol)
    r = trace_ray(prm, sph, dsc, cols[p], rows[p],
                  sobol_noise(prm, pid[p], (uint32_t)base[p] + (uint32_t)sample_idx, (uint32_t)p,
                              (uint32_t)sample_idx));
  else
    r = trace_ray(prm, sph, dsc, cols[p], rows[p],
                  PhiloxNoise{prm.seed0, prm.seed1, (uint32_t)p, (uint32_t)sample_idx});
  rad[p] = r.radiance.x;
  rad[n + p] = r.radiance.y;
  rad[2 * n + p] = r.radiance.z;
  escd[p] = r.esc_dir.x;
  escd[n + p] = r.esc_dir.y;
  escd[2 * n + p] = r.esc_dir.z;
  escw[p] = r.esc_w.x;
  escw[n + p] = r.esc_w.y;
  escw[2 * n + p] = r.esc_w.z;
  escm[p] = r.escaped;
  plen[p] = r.path_len;
}

}  // namespace pt

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// noise != nullptr selects host noise ((4 + 4L, n) rows); otherwise
// pid != nullptr selects Sobol mode (per-lane pixel ids and sequence
// bases, prm->sobol_dims / sobol_key, Philox tail), else hardware (Philox)
// mode seeded by prm->seed0/1.
extern "C" int pt_trace(const pt::TraceParams* prm, const float* sph, const float* dsc,
                        const float* cols, const float* rows, const float* noise, const int* pid,
                        const int* base, int sample_idx, int n, float* rad, float* escd,
                        float* escw, int* escm, int* plen, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = pt::tables_bytes(*prm);
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks == 0) return 0;
  if (noise)
    pt::trace_kernel<pt::kRngHost><<<blocks, threads, smem, s>>>(
        *prm, sph, dsc, cols, rows, noise, pid, base, sample_idx, n, rad, escd, escw, escm, plen);
  else if (pid)
    pt::trace_kernel<pt::kRngSobol><<<blocks, threads, smem, s>>>(
        *prm, sph, dsc, cols, rows, noise, pid, base, sample_idx, n, rad, escd, escw, escm, plen);
  else
    pt::trace_kernel<pt::kRngPhilox><<<blocks, threads, smem, s>>>(
        *prm, sph, dsc, cols, rows, noise, pid, base, sample_idx, n, rad, escd, escw, escm, plen);
  return (int)cudaGetLastError();
}
