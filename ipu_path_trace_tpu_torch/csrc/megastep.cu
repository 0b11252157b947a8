// K3: the whole render step - for each of `samples` samples, trace every
// ray of the block's tile (K1's device code) and shade its escape with the
// NIF (K2's device code), summing radiance and path length in registers.
//
// Replaces ipu_path_trace_tpu/ops/megastep_pallas.py::render_megastep_pallas
// (kernel body _kernel, :174).  One block of pt::kThreads threads owns
// kRaysPerBlock rays for the whole step, one ray per thread in the trace
// phase.  After each sample the escape directions and weights go to shared
// memory and the block runs the NIF chain over them in kTile-ray sub-tiles
// (nif_dev.cuh), so neither the trace state nor the escape records nor
// the activations ever reach device memory: the step reads the pixel
// coordinates (and host noise, in that mode) and writes 4 words per ray.
// The kernel is instantiated per RNG mode and per chain (bf16, or int8 as
// the TPU kernel's quant branch); the launcher picks by its arguments.
//
// What bounds it: the NIF chain's multiply-adds (nif_dev.cuh), as on the
// TPU, plus the trace's divergent per-ray loop.  The TPU kernel shades
// sample s - 1 during iteration s to overlap its matrix and vector units;
// here each sample is shaded in its own iteration, which gives the same
// sum.
#include "nif_dev.cuh"

namespace pt {

constexpr int kRaysPerBlock = kThreads;
constexpr int kSubTiles = kRaysPerBlock / kTile;

struct MegaSmem {
  size_t tables, escd, escw, env;
  NifSmem nif;
};

inline MegaSmem mega_smem_plan(const TraceParams& prm, const NifNet& net) {
  MegaSmem s;
  s.tables = 0;
  s.escd = align16(tables_bytes(prm));
  s.escw = s.escd + align16(3 * kRaysPerBlock * sizeof(float));
  s.env = s.escw + align16(3 * kRaysPerBlock * sizeof(float));
  s.nif = nif_smem_plan(net, s.env + align16(3 * kRaysPerBlock * sizeof(float)));
  return s;
}

template <bool kHostNoise, bool kInt8>
__global__ void __launch_bounds__(kThreads, 2) megastep_kernel(
    TraceParams prm, NifNet net, MegaSmem plan, const float* __restrict__ sph_g,
    const float* __restrict__ dsc_g, const float* __restrict__ cols,
    const float* __restrict__ rows, const float* __restrict__ noise, int samples, int n,
    float* __restrict__ rad_out, int* __restrict__ plen_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tables = (float*)(smem + plan.tables);
  float* s_escd = (float*)(smem + plan.escd);  // [3][kRaysPerBlock]
  float* s_escw = (float*)(smem + plan.escw);
  float* s_env = (float*)(smem + plan.env);  // [3][kRaysPerBlock] rgb contribution
  const NifTile t(smem, plan.nif);
  load_tables(prm, sph_g, dsc_g, s_tables);
  __syncthreads();
  const float* sph = s_tables;
  const float* dsc = s_tables + prm.num_s * kSphereF;

  const int tid = threadIdx.x;
  const int p = blockIdx.x * kRaysPerBlock + tid;
  const bool live = p < n;  // the ragged tail still joins every barrier
  const float col = live ? cols[p] : 0.0f, row = live ? rows[p] : 0.0f;
  const long long sample_stride = (long long)(4 + 4 * prm.max_path_length) * n;
  V3 acc = {0.0f, 0.0f, 0.0f};
  int acc_len = 0;

  for (int s = 0; s < samples; ++s) {
    TraceResult r;
    r.radiance = r.esc_dir = r.esc_w = V3{0.f, 0.f, 0.f};
    r.path_len = 0;
    if (live) {
      if (kHostNoise)
        r = trace_ray(prm, sph, dsc, col, row,
                      HostNoise{noise + s * sample_stride + p, (long long)n});
      else
        r = trace_ray(prm, sph, dsc, col, row,
                      PhiloxNoise{prm.seed0, prm.seed1, (uint32_t)p, (uint32_t)s});
    }
    acc = acc + r.radiance;
    acc_len += r.path_len;
    s_escd[tid] = r.esc_dir.x;
    s_escd[kRaysPerBlock + tid] = r.esc_dir.y;
    s_escd[2 * kRaysPerBlock + tid] = r.esc_dir.z;
    s_escw[tid] = r.esc_w.x;
    s_escw[kRaysPerBlock + tid] = r.esc_w.y;
    s_escw[2 * kRaysPerBlock + tid] = r.esc_w.z;
    __syncthreads();

    for (int sub = 0; sub < kSubTiles; ++sub) {
      const int q = sub * kTile + tid;
      if (tid < kTile)
        equirect_uv(s_escd[q], s_escd[kRaysPerBlock + q], s_escd[2 * kRaysPerBlock + q],
                    prm.azimuth, &t.u[tid], &t.v[tid]);
      __syncthreads();
      nif_chain<kInt8>(net, t);  // ends with a barrier
      if (tid < kTile) {  // bgr -> rgb flip times the escape weights
        s_env[q] = s_escw[q] * t.out[2 * kTile + tid];
        s_env[kRaysPerBlock + q] = s_escw[kRaysPerBlock + q] * t.out[kTile + tid];
        s_env[2 * kRaysPerBlock + q] = s_escw[2 * kRaysPerBlock + q] * t.out[tid];
      }
    }
    __syncthreads();
    acc = acc + V3{s_env[tid], s_env[kRaysPerBlock + tid], s_env[2 * kRaysPerBlock + tid]};
  }
  if (live) {
    rad_out[p] = acc.x;
    rad_out[n + p] = acc.y;
    rad_out[2 * n + p] = acc.z;
    plen_out[p] = acc_len;
  }
}

template <bool kHostNoise, bool kInt8>
int launch_megastep(const TraceParams& prm, const NifNet& net, const MegaSmem& plan,
                    const float* sph, const float* dsc, const float* cols, const float* rows,
                    const float* noise, int samples, int n, float* rad, int* plen,
                    cudaStream_t stream) {
  const int smem = (int)plan.nif.total;
  cudaError_t err = cudaFuncSetAttribute(megastep_kernel<kHostNoise, kInt8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRaysPerBlock - 1) / kRaysPerBlock;
  if (blocks == 0) return 0;
  megastep_kernel<kHostNoise, kInt8><<<blocks, kThreads, smem, stream>>>(
      prm, net, plan, sph, dsc, cols, rows, noise, samples, n, rad, plen);
  return (int)cudaGetLastError();
}

}  // namespace pt

// noise == nullptr selects hardware (Philox) mode seeded by prm->seed0/1;
// otherwise noise is (samples, 4 + 4L, n).
extern "C" int pt_megastep(const pt::TraceParams* prm, const pt::NifNet* net, const float* sph,
                           const float* dsc, const float* cols, const float* rows,
                           const float* noise, int samples, int n, float* rad, int* plen,
                           void* stream) {
  const pt::MegaSmem plan = pt::mega_smem_plan(*prm, *net);
  cudaStream_t s = (cudaStream_t)stream;
  if (noise && net->int8)
    return pt::launch_megastep<true, true>(*prm, *net, plan, sph, dsc, cols, rows, noise,
                                           samples, n, rad, plen, s);
  if (noise)
    return pt::launch_megastep<true, false>(*prm, *net, plan, sph, dsc, cols, rows, noise,
                                            samples, n, rad, plen, s);
  if (net->int8)
    return pt::launch_megastep<false, true>(*prm, *net, plan, sph, dsc, cols, rows, noise,
                                            samples, n, rad, plen, s);
  return pt::launch_megastep<false, false>(*prm, *net, plan, sph, dsc, cols, rows, noise,
                                           samples, n, rad, plen, s);
}
