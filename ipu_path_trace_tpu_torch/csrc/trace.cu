// K1: one sample per pixel through the whole bounce loop, in hardware
// (Philox), host-noise or Owen-Sobol mode (csrc/common.cuh).
//
// Replaces ipu_path_trace_tpu/ops/trace_pallas.py::trace_sample_pallas
// (kernel body _kernel, :408).  The scene tables (12 f32 per sphere, 15 per
// disc) sit in shared memory, where every lane of a warp reads the same
// word at each step of the intersection loop (a broadcast); from
// __constant__ memory the kernel ran slower in every mode.
//
// What bounds it: arithmetic and divergence, not memory - a ray reads its
// pixel and (in host-noise mode) 4 + 4L noise floats and writes 11 words,
// while it spends a few hundred flops per bounce on the intersection chain
// and the BSDF.  Rays leave the loop at different bounces: on the main
// path most escape at their first (1.6 bounces a ray on average), and the
// longest path of a 32-ray warp averages 2.8, so a warp that keeps its 32
// rays to the end runs its bounce loop at ~58% SIMT efficiency (the TPU
// hid the same spread behind two block-wide lax.cond early-outs).
//
// The design, lane refill (Aila and Laine, "Understanding the Efficiency of
// Ray Traversal on GPUs", HPG 2009: persistent warps with dynamic fetch):
// one persistent block per SM slot, and each warp takes batches of 32 ray
// indices from a global counter, one atomicAdd per batch by lane 0.  The
// loop runs one bounce per iteration: a lane whose ray has ended (escape,
// emitter, roulette or the path length) stores its 11 words and, once 8
// lanes of its warp are idle, starts the next index of the warp's batch
// (its raygen); a warp whose batch runs short fetches the next batch.  So
// a warp's lanes stay busy until the counter runs dry, and only the last
// rays of each warp leave lanes idle.  Every ray's noise is keyed by its
// index (Philox counter (p, sample, g), Sobol pid[p] / base[p], host-noise
// column p) and its steps are trace_ray's (ray_begin, ray_bounce), so which
// lane traces a ray changes no bit: K1 equals its plain version bit for bit
// as before.
// What bounds the gain: the bounce loop's SIMT efficiency, at most 1/0.58
// ~ 1.7x, less the raygen that now runs in a divergent branch once per
// refill and the stores, which no longer coalesce across a whole warp.  On
// the H100 the kernel is held by latency more than by issue: the gain over
// one thread per ray is 3-15% by mode (PERF.md; probes/trace_ablation.py
// rebuilds the alternatives), and it needs the warps per SM that a lean
// register set allows - so a lane carries only its ray's origin, direction
// and throughput, and takes what the ray gathers from its last bounce.  The
// ragged tail of the batch is masked in the kernel, so the host never pads.
#include "common.cuh"

namespace pt {

constexpr int kTraceThreads = 256;
// A warp refills once this many of its lanes are idle (or all are): fewer
// raygen branches, each for more lanes.
constexpr int kRefillLanes = 8;

// The noise of ray p in mode kRng (common.cuh).
template <int kRng>
PT_HD auto ray_noise(const TraceParams& prm, const float* noise, const int* pid, const int* base,
                     int sample_idx, int n, int p) {
  if constexpr (kRng == kRngHost)
    return HostNoise{noise + p, (long long)n};
  else if constexpr (kRng == kRngSobol)
    return sobol_noise(prm, pid[p], (uint32_t)base[p] + (uint32_t)sample_idx, (uint32_t)p,
                       (uint32_t)sample_idx);
  else
    return PhiloxNoise{prm.seed0, prm.seed1, (uint32_t)p, (uint32_t)sample_idx};
}

template <int kRng>
__global__ void __launch_bounds__(kTraceThreads) trace_kernel(
    TraceParams prm, const float* __restrict__ sph_g, const float* __restrict__ dsc_g,
    const float* __restrict__ cols, const float* __restrict__ rows,
    const float* __restrict__ noise, const int* __restrict__ pid, const int* __restrict__ base,
    int sample_idx, int n, int* __restrict__ next_ray, float* __restrict__ rad,
    float* __restrict__ escd, float* __restrict__ escw, int* __restrict__ escm,
    int* __restrict__ plen) {
  extern __shared__ float s_tables[];
  load_tables(prm, sph_g, dsc_g, s_tables);
  __syncthreads();
  const float* sph = s_tables;
  const float* dsc = s_tables + prm.num_s * kSphereF;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  // The warp's batch: indices next .. end - 1 not yet started (warp-uniform).
  int next = 0, end = 0;
  bool drained = false;
  // This lane's ray (p < 0: none) and its state before bounce b; what a
  // ray gathers is set by its last bounce alone, so it is not carried.
  int p = -1, b = 0;
  V3 o, d, tp;
  decltype(ray_noise<kRng>(prm, noise, pid, base, sample_idx, n, 0)) nz;
  while (true) {
    // Refill, once kRefillLanes lanes are idle: the lanes without a ray take
    // the batch's next indices in lane order, and the batch's rest and a
    // fresh batch when it runs short.
    const unsigned idle = __ballot_sync(~0u, p < 0);
    if ((__popc(idle) >= kRefillLanes || idle == ~0u) && !drained) {
      const int need = __popc(idle), have = end - next;
      int fresh = 0;
      if (have < need) {
        if (lane == 0) fresh = atomicAdd(next_ray, 32);
        fresh = __shfl_sync(~0u, fresh, 0);
      }
      if (p < 0) {
        const int rank = __popc(idle & below);
        const int q = rank < have ? next + rank : fresh + rank - have;
        if (q < n) {
          p = q;
          b = 0;
          nz = ray_noise<kRng>(prm, noise, pid, base, sample_idx, n, p);
          ray_begin(prm, cols[p], rows[p], nz, o, d);
          tp = V3{1.0f, 1.0f, 1.0f};
        }
      }
      if (have < need) {
        drained = fresh >= n;
        end = min(fresh + 32, n);
        next = min(fresh + need - have, end);
      } else {
        next += need;
      }
    }
    if (__ballot_sync(~0u, p >= 0) == 0u) break;  // the counter is dry and every ray stored
    if (p >= 0) {
      TraceResult res = no_result();
      const int before = b;  // bounces done, each of which added one to the path length
      const bool on = b < prm.max_path_length && ray_bounce(prm, sph, dsc, nz, b, o, d, tp, res);
      if (!on || ++b == prm.max_path_length) {
        rad[p] = res.radiance.x;
        rad[n + p] = res.radiance.y;
        rad[2 * n + p] = res.radiance.z;
        escd[p] = res.esc_dir.x;
        escd[n + p] = res.esc_dir.y;
        escd[2 * n + p] = res.esc_dir.z;
        escw[p] = res.esc_w.x;
        escw[n + p] = res.esc_w.y;
        escw[2 * n + p] = res.esc_w.z;
        escm[p] = res.escaped;
        plen[p] = before + res.path_len;
        p = -1;
      }
    }
  }
}

}  // namespace pt

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// noise != nullptr selects host noise ((4 + 4L, n) rows); otherwise
// pid != nullptr selects Sobol mode (per-lane pixel ids and sequence
// bases, prm->sobol_dims / sobol_key, Philox tail), else hardware (Philox)
// mode seeded by prm->seed0/1.  next_ray is one int of scratch on the
// device (the batch counter), zeroed here on the stream before the kernel.
extern "C" int pt_trace(const pt::TraceParams* prm, const float* sph, const float* dsc,
                        const float* cols, const float* rows, const float* noise, const int* pid,
                        const int* base, int sample_idx, int n, int* next_ray, float* rad,
                        float* escd, float* escw, int* escm, int* plen, void* stream) {
  if (n <= 0) return 0;
  void (*const kernel)(pt::TraceParams, const float*, const float*, const float*, const float*,
                       const float*, const int*, const int*, int, int, int*, float*, float*,
                       float*, int*, int*) =
      noise ? pt::trace_kernel<pt::kRngHost>
            : (pid ? pt::trace_kernel<pt::kRngSobol> : pt::trace_kernel<pt::kRngPhilox>);
  const size_t smem = pt::tables_bytes(*prm);
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, pt::kTraceThreads,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int needed = (n + pt::kTraceThreads - 1) / pt::kTraceThreads;
  const int blocks = needed < sms * per_sm ? needed : sms * per_sm;
  if ((err = cudaMemsetAsync(next_ray, 0, sizeof(int), s)) != cudaSuccess) return (int)err;
  kernel<<<blocks, pt::kTraceThreads, smem, s>>>(*prm, sph, dsc, cols, rows, noise, pid, base,
                                                 sample_idx, n, next_ray, rad, escd, escw, escm,
                                                 plen);
  return (int)cudaGetLastError();
}
