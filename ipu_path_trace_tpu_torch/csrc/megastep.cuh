// K3: the whole render step - for each of the step's samples, trace every
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
// coordinates (and host noise, in that mode) and writes 4 words per ray
// (5 with the statistics).  The kernel is instantiated per RNG mode
// (Philox, host noise, Owen-Sobol) and per chain (bf16, or int8 as the
// TPU kernel's quant branch); the launcher picks by its arguments.  The
// other modes are runtime arguments:
//  * budgets (adaptive sampling): budgets[g] samples for the rays of
//    budget block g (budget_block rays, a multiple of kRaysPerBlock, so a
//    budget is uniform over a CUDA block, as nif_chain's barriers need).
//    It is the sample-loop bound; with host noise the loop also stops at
//    the noise's S rows, which gates rows >= budget to exact zeros as the
//    TPU kernel's multiplicative gate does;
//  * lum2 != nullptr (with_stats): the sum over samples of the squared
//    Rec.709 luminance of each sample's radiance (direct + env);
//  * env_skip: a NIF sub-tile whose escape weights are all zero skips the
//    chain; its contribution would be exact zeros, so the result does not
//    change (the TPU kernel's _env_contrib guard, at sub-tile granularity).
//
// What bounds it: the NIF chain's multiply-adds (nif_dev.cuh), as on the
// TPU, plus the trace's divergent per-ray loop.  The TPU kernel shades
// sample s - 1 during iteration s to overlap its matrix and vector units;
// here each sample is shaded in its own iteration, which gives the same
// sum and lets the statistics fold each sample as soon as it is shaded.
//
// The measurement stubs of --device-timing (utils/devtime.py) are a
// template parameter, so the production kernels (kStubNone, built by
// megastep.cu) compile exactly as without them; megastep_stub.cu builds
// the stubbed kernels.  kStubNif replaces the NIF chain by
// nif_chain_stub, kStubTrace the bounce by trace_ray<true>'s stub.
#pragma once

#include "nif_dev.cuh"

namespace pt {

enum StubMode { kStubNone = 0, kStubNif = 1, kStubTrace = 2, kStubBoth = 3 };

constexpr int kRaysPerBlock = kThreads;
constexpr int kSubTiles = kRaysPerBlock / kTile;

struct MegaSmem {
  size_t tables, escd, escw, rad;
  NifSmem nif;
};

inline MegaSmem mega_smem_plan(const TraceParams& prm, const NifNet& net) {
  MegaSmem s;
  s.tables = 0;
  s.escd = align16(tables_bytes(prm));
  s.escw = s.escd + align16(3 * kRaysPerBlock * sizeof(float));
  s.rad = s.escw + align16(3 * kRaysPerBlock * sizeof(float));
  s.nif = nif_smem_plan(net, s.rad + align16(3 * kRaysPerBlock * sizeof(float)));
  return s;
}

// Rec.709 luma weights (megastep_pallas.py LUM_R/G/B) for the statistics.
constexpr float kLumR = 0.2126f, kLumG = 0.7152f, kLumB = 0.0722f;

template <int kRng, bool kInt8, int kStub>
__global__ void __launch_bounds__(kThreads, 2) megastep_kernel(
    TraceParams prm, NifNet net, MegaSmem plan, const float* __restrict__ sph_g,
    const float* __restrict__ dsc_g, const float* __restrict__ cols,
    const float* __restrict__ rows, const float* __restrict__ noise,
    const int* __restrict__ pid, const int* __restrict__ base,
    const int* __restrict__ budgets, int budget_block, int samples, int n, int env_skip,
    float* __restrict__ rad_out, int* __restrict__ plen_out, float* __restrict__ lum2_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tables = (float*)(smem + plan.tables);
  float* s_escd = (float*)(smem + plan.escd);  // [3][kRaysPerBlock]
  float* s_escw = (float*)(smem + plan.escw);
  float* s_rad = (float*)(smem + plan.rad);  // [3][kRaysPerBlock] the sample's radiance
  const NifTile t(smem, plan.nif);
  load_tables(prm, sph_g, dsc_g, s_tables);
  __syncthreads();
  const float* sph = s_tables;
  const float* dsc = s_tables + prm.num_s * kSphereF;

  const int tid = threadIdx.x;
  const int p = blockIdx.x * kRaysPerBlock + tid;
  const bool live = p < n;  // the ragged tail still joins every barrier
  const float col = live ? cols[p] : 0.0f, row = live ? rows[p] : 0.0f;
  int pixel = 0;
  uint32_t seq0 = 0u;
  if (kRng == kRngSobol && live) {
    pixel = pid[p];
    seq0 = (uint32_t)base[p];
  }
  const long long sample_stride = (long long)(4 + 4 * prm.max_path_length) * n;
  int n_samples = samples;
  if (budgets) {
    const int bud = budgets[(blockIdx.x * kRaysPerBlock) / budget_block];
    n_samples = kRng == kRngHost ? min(bud, samples) : bud;
  }
  V3 acc = {0.0f, 0.0f, 0.0f};
  int acc_len = 0;
  float acc_l2 = 0.0f;

  for (int s = 0; s < n_samples; ++s) {
    TraceResult r;
    r.radiance = r.esc_dir = r.esc_w = V3{0.f, 0.f, 0.f};
    r.path_len = 0;
    if (live) {
      constexpr bool kStubBounce = (kStub & kStubTrace) != 0;
      if constexpr (kRng == kRngHost)
        r = trace_ray<kStubBounce>(prm, sph, dsc, col, row,
                                   HostNoise{noise + s * sample_stride + p, (long long)n});
      else if constexpr (kRng == kRngSobol)
        r = trace_ray<kStubBounce>(
            prm, sph, dsc, col, row,
            sobol_noise(prm, pixel, seq0 + (uint32_t)s, (uint32_t)p, (uint32_t)s));
      else
        r = trace_ray<kStubBounce>(prm, sph, dsc, col, row,
                                   PhiloxNoise{prm.seed0, prm.seed1, (uint32_t)p, (uint32_t)s});
    }
    acc_len += r.path_len;
    s_escd[tid] = r.esc_dir.x;
    s_escd[kRaysPerBlock + tid] = r.esc_dir.y;
    s_escd[2 * kRaysPerBlock + tid] = r.esc_dir.z;
    s_escw[tid] = r.esc_w.x;
    s_escw[kRaysPerBlock + tid] = r.esc_w.y;
    s_escw[2 * kRaysPerBlock + tid] = r.esc_w.z;
    s_rad[tid] = r.radiance.x;  // the env contribution is added below
    s_rad[kRaysPerBlock + tid] = r.radiance.y;
    s_rad[2 * kRaysPerBlock + tid] = r.radiance.z;
    __syncthreads();

    for (int sub = 0; sub < kSubTiles; ++sub) {
      const int q = sub * kTile + tid;
      if (env_skip) {  // block-uniform: a barrier that ORs the tile's escapes
        const bool escapes = tid < kTile && (s_escw[q] != 0.0f ||
                                             s_escw[kRaysPerBlock + q] != 0.0f ||
                                             s_escw[2 * kRaysPerBlock + q] != 0.0f);
        if (!__syncthreads_or(escapes)) continue;
      }
      if (tid < kTile)
        equirect_uv(s_escd[q], s_escd[kRaysPerBlock + q], s_escd[2 * kRaysPerBlock + q],
                    prm.azimuth, &t.u[tid], &t.v[tid]);
      __syncthreads();
      if constexpr ((kStub & kStubNif) != 0)  // ends with a barrier
        nif_chain_stub<kInt8>(net, t);
      else
        nif_chain<kInt8>(net, t);
      if (tid < kTile) {  // direct + (bgr -> rgb flip times the escape weights)
        s_rad[q] = s_rad[q] + s_escw[q] * t.out[2 * kTile + tid];
        s_rad[kRaysPerBlock + q] =
            s_rad[kRaysPerBlock + q] + s_escw[kRaysPerBlock + q] * t.out[kTile + tid];
        s_rad[2 * kRaysPerBlock + q] =
            s_rad[2 * kRaysPerBlock + q] + s_escw[2 * kRaysPerBlock + q] * t.out[tid];
      }
    }
    __syncthreads();
    const V3 tr = {s_rad[tid], s_rad[kRaysPerBlock + tid], s_rad[2 * kRaysPerBlock + tid]};
    acc = acc + tr;
    if (lum2_out) {
      const float lum = kLumR * tr.x + kLumG * tr.y + kLumB * tr.z;
      acc_l2 = acc_l2 + lum * lum;
    }
  }
  if (live) {
    rad_out[p] = acc.x;
    rad_out[n + p] = acc.y;
    rad_out[2 * n + p] = acc.z;
    plen_out[p] = acc_len;
    if (lum2_out) lum2_out[p] = acc_l2;
  }
}

struct MegaArgs {
  const float *sph, *dsc, *cols, *rows, *noise;
  const int *pid, *base, *budgets;
  int budget_block, samples, n, env_skip;
  float* rad;
  int* plen;
  float* lum2;
};

template <int kRng, bool kInt8, int kStub>
int launch_megastep(const TraceParams& prm, const NifNet& net, const MegaSmem& plan,
                    const MegaArgs& a, cudaStream_t stream) {
  const int smem = (int)plan.nif.total;
  cudaError_t err = cudaFuncSetAttribute(megastep_kernel<kRng, kInt8, kStub>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.n + kRaysPerBlock - 1) / kRaysPerBlock;
  if (blocks == 0) return 0;
  megastep_kernel<kRng, kInt8, kStub><<<blocks, kThreads, smem, stream>>>(
      prm, net, plan, a.sph, a.dsc, a.cols, a.rows, a.noise, a.pid, a.base, a.budgets,
      a.budget_block, a.samples, a.n, a.env_skip, a.rad, a.plen, a.lum2);
  return (int)cudaGetLastError();
}

// The kernel of net's chain (bf16 or int8) in RNG mode kRng.
template <int kRng, int kStub>
int launch_chain(const TraceParams& prm, const NifNet& net, const MegaArgs& a,
                 cudaStream_t stream) {
  if (a.budgets && (a.budget_block <= 0 || a.budget_block % kRaysPerBlock))
    return (int)cudaErrorInvalidValue;
  const MegaSmem plan = mega_smem_plan(prm, net);
  return net.int8 ? launch_megastep<kRng, true, kStub>(prm, net, plan, a, stream)
                  : launch_megastep<kRng, false, kStub>(prm, net, plan, a, stream);
}

}  // namespace pt
