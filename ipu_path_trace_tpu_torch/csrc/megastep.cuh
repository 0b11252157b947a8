// K3: the whole render step - for each of the step's samples, trace every
// ray of the block's rays (K1's device code) and shade its escape with the
// NIF (K2's device code), summing radiance and path length in registers.
//
// Replaces ipu_path_trace_tpu/ops/megastep_pallas.py::render_megastep_pallas
// (kernel body _kernel, :174).  One block owns kRaysPerBlock = 256 rays for
// the whole step, one ray per tracing thread.  After each sample the block
// runs the NIF chain over the sample's escapes, so neither the trace state
// nor the escape records nor the activations ever reach device memory: the
// step reads the pixel coordinates (and host noise, in that mode) and writes
// 4 words per ray (5 with the statistics).  One kernel, megastep_wg_kernel,
// on the wgmma chains of nif_wgmma.cuh - bf16, or int8 (K5, the s8 slices;
// the TPU kernel's quant branch) as its kInt8 parameter says.  A block of
// kWgThreads = 384 threads: the 256 threads of the two consumer warpgroups
// each trace one ray, then the sample's 256 escapes are shaded as two
// 128-ray wgmma tiles (rays 0-127, then 128-255; in each, either warpgroup
// holds 64 rows), and the producer warpgroup only streams weight slices.
// Each tracing thread keeps its ray's escape weights and direct radiance in
// registers; only the (u, v) of the escapes and the head's decoded outputs
// go through shared memory.  After the role split the producer has
// returned, so every barrier of the loop is a named one over the 256
// consumer threads (consumers_sync), never __syncthreads.  The blocks are
// not persistent (one per 256 rays, one resident per SM by its shared
// memory and registers) and the first fill is lazy: the producer streams
// nothing until the consumers first ask for a tile (kCtlGo), then the
// slice sequence tile after tile (wg_stream), and stops when the consumers
// say the block is done (kCtlDone), so a block whose tiles are all skipped
// reads no weights.
// The kernel is instantiated per RNG mode (Philox, host noise, Owen-Sobol)
// and chain; the launcher picks by its arguments and the NifWg's int8
// flag.  The other modes are runtime arguments:
//  * budgets (adaptive sampling): budgets[g] samples for the rays of
//    budget block g (budget_block rays, a multiple of kRaysPerBlock, so a
//    budget is uniform over a CUDA block, as the chain's block-wide
//    barriers and both warpgroups' consumption of every slice need).  It is
//    the sample-loop bound, 0 included; with host noise the loop also stops
//    at the noise's S rows, which gates rows >= budget to exact zeros as
//    the TPU kernel's multiplicative gate does;
//  * lum2 != nullptr (with_stats): the sum over samples of the squared
//    Rec.709 luminance of each sample's radiance (direct + env);
//  * env_skip: a 128-ray wgmma tile whose escape weights are all zero skips
//    the chain (ops/megastep.py::ENV_SKIP_TILE); its contribution would be
//    exact zeros, so the result does not change (the TPU kernel's
//    _env_contrib guard, at tile granularity).  A tile with no live ray
//    (the ragged tail) is skipped in any case.
//
// What bounds it: the NIF chain, as on the TPU (nif_wgmma.cuh says what
// holds each chain; the weight slices, 1,111,040 B bf16 or 555,520 B int8
// per tile, do not), plus the trace's divergent per-ray loop; with one
// 384-thread block per SM, 8 warps per SM trace.  The TPU kernel shades sample s - 1
// during iteration s to overlap its matrix and vector units; here each
// sample is shaded in its own iteration (the producer prefetches the next
// tile's first slices during the trace), which gives the same sum and lets
// the statistics fold each sample as soon as it is shaded.
//
// Shared memory (ops/megastep.py::megastep_wg_plan; the chain's plan with
// K3's tail after the barriers), canonical 6x320 net and the default scene
// (5 spheres, 1 disc):
//   bf16: activations 81,920 B, features 16,384 B, ring 3 stages x 40,960 B
//   = 122,880 B, barriers 64 B, (u, v) 256 x 8 = 2,048 B, head outputs
//   3 x 256 x 4 = 3,072 B, control word 16 B, scene tables 304 B, 1,024-B
//   alignment slack: 227,712 of the 232,448 B a block may use.  The stages
//   are as many as fit (at most 4); 2 stages leave room for 46,000 B of
//   tables; a scene with more raises in the plan;
//   int8: activations 40,960 B, features 8,192 B, the skip layer's codes
//   32,768 B, ring 4 x 20,480 B, the tail as bf16: 170,368 B.
//
// The measurement stubs of --device-timing (utils/devtime.py) are a
// template parameter, so the production kernels (kStubNone, built by
// megastep.cu) compile exactly as without them; megastep_stub.cu builds
// the stubbed kernels.  kStubNif replaces the chain by wg_tile_stub (in the
// same blocks and tiles, with no weight copies and no MMAs), kStubTrace the
// bounce by trace_ray<true>'s stub (the real chain then runs on zero
// escape weights).
#pragma once

#include "nif_wgmma.cuh"

namespace pt {

enum StubMode { kStubNone = 0, kStubNif = 1, kStubTrace = 2, kStubBoth = 3 };

constexpr int kRaysPerBlock = 2 * kWgRays;  // two wgmma tiles

// Rec.709 luma weights (megastep_pallas.py LUM_R/G/B) for the statistics.
constexpr float kLumR = 0.2126f, kLumG = 0.7152f, kLumB = 0.0722f;

// K3's tail of the chain's plan, at net.smem_uv: the block's u[256] and
// v[256], the head's outputs [3][256] (network order), the control word
// (WgCtl, 16 B), then the scene tables.
constexpr int kMegaUvBytes = 2 * kRaysPerBlock * 4;
constexpr int kMegaOutBytes = 3 * kRaysPerBlock * 4;
constexpr int kMegaCtlBytes = 16;
constexpr int kWgAlignSlack = 1024;  // the plan's slack for the 1024-byte alignment

__host__ __device__ inline int mega_tables_offset(const NifWg& net) {
  return net.smem_uv + kMegaUvBytes + kMegaOutBytes + kMegaCtlBytes;
}

// The head's decoded outputs into the block's [3][256] array.
struct MegaWgIo {
  float* out;
  int n;
  PT_HD void store(int o, int ray, float y) const { out[o * kRaysPerBlock + ray] = y; }
};

// K3's Owen-Sobol rows: common.cuh::SobolNoise's numbers (the
// same XOR of the same direction numbers, so bit for bit) with its 32-step
// sum unrolled by 8 instead of fully.  Fully unrolled, a group's four
// dimensions keep ~128 direction words in flight, which beside what the
// consumers hold across the chain spills at setmaxnreg's 232 registers;
// unrolled by 8 nothing spills (chip_smoke.py's ptxas phase checks it).
struct SobolNoiseK3 : SobolNoise {
  PT_HD explicit SobolNoiseK3(const SobolNoise& s) : SobolNoise(s) {}

  PT_HD float unit(int d) const {
    uint32_t acc;
    if (d == 0) {
      acc = __brev(h);  // dimension 0 is the identity matrix
    } else {
      acc = 0u;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) acc ^= (0u - ((h >> (31 - k)) & 1u)) & kSobolRevDirs[d][k];
    }
    return u24(__brev(laine_karras(acc, lowbias32(key + (uint32_t)d * 0x9E3779B9u))));
  }

  PT_HD void group(int g, float out[4]) const {
    if (4 * g < dims) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = unit(4 * g + j);
    } else {
      tail.group(g, out);
    }
  }
};

static_assert(kWgConsumers == kRaysPerBlock,
              "a block's tracing threads are its two consumer warpgroups, its rays two tiles");

template <int kRng, int kStub, bool kInt8>
__global__ void __launch_bounds__(kWgThreads, 1) megastep_wg_kernel(
    TraceParams prm, NifWg net, const float* __restrict__ sph_g, const float* __restrict__ dsc_g,
    const float* __restrict__ cols, const float* __restrict__ rows,
    const float* __restrict__ noise, const int* __restrict__ pid, const int* __restrict__ base,
    const int* __restrict__ budgets, int budget_block, int samples, int n, int env_skip,
    float* __restrict__ rad_out, int* __restrict__ plen_out, float* __restrict__ lum2_out) {
  using Chain = NifChain<kInt8>;
  constexpr bool kStubChain = (kStub & kStubNif) != 0;
  constexpr int kTileUnroll = kStub == kStubNone ? 1 : 2;
  const WgBlock b = wg_block(net);
  float* const s_u = (float*)(b.smem + net.smem_uv);
  float* const s_v = s_u + kRaysPerBlock;
  float* const s_out = s_v + kRaysPerBlock;
  volatile int* const ctl = (volatile int*)(s_out + 3 * kRaysPerBlock);
  float* const s_tables = (float*)(b.smem + mega_tables_offset(net));
  wg_setup(net, b);
  if (threadIdx.x == 0) *ctl = kCtlIdle;
  load_tables(prm, sph_g, dsc_g, s_tables);
  __syncthreads();
  if (wg_producer_role([&] {
        if constexpr (!kStubChain) {  // the stub copies nothing
          WgProducer prod{b.full, b.empty, b.s0 + net.smem_ring, 0, 0, 0};
          wg_stream(net, prod, ctl);
        }
      }))
    return;
  // From here on only the 256 consumer threads run: consumers_sync, never
  // __syncthreads.
  WgConsumer c = wg_consumer<kInt8>(net, b);
  const float* sph = s_tables;
  const float* dsc = s_tables + prm.num_s * kSphereF;
  const MegaWgIo io{s_out, kRaysPerBlock};

  const int tid = threadIdx.x;
  const int p = blockIdx.x * kRaysPerBlock + tid;
  const bool live = p < n;  // the ragged tail still joins every barrier
  const bool tile1_live = n - blockIdx.x * kRaysPerBlock > kWgRays;
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
        r = trace_ray<kStubBounce>(prm, sph, dsc, col, row,
                                   SobolNoiseK3(sobol_noise(prm, pixel, seq0 + (uint32_t)s,
                                                            (uint32_t)p, (uint32_t)s)));
      else
        r = trace_ray<kStubBounce>(prm, sph, dsc, col, row,
                                   PhiloxNoise{prm.seed0, prm.seed1, (uint32_t)p, (uint32_t)s});
    }
    acc_len += r.path_len;
    equirect_uv(r.esc_dir.x, r.esc_dir.y, r.esc_dir.z, prm.azimuth, &s_u[tid], &s_v[tid]);
    // Which of the two tiles to shade (block-uniform): tile t holds the rays
    // of warpgroup t.  The barriers also publish the (u, v).
    bool shade0 = true, shade1 = tile1_live;
    if (env_skip) {
      const bool escapes = r.esc_w.x != 0.0f || r.esc_w.y != 0.0f || r.esc_w.z != 0.0f;
      shade0 = consumers_or(c.wg == 0 && escapes);
      shade1 = consumers_or(c.wg == 1 && escapes) && shade1;
    } else {
      consumers_sync();
    }
    if (!kStubChain && tid == 0 && (shade0 || shade1)) *ctl = kCtlGo;
    // The loop is unrolled in the stubs and not in the production kernels:
    // so ptxas allocates every instantiation without spills at 240
    // registers (chip_smoke.py's ptxas phase), which neither choice alone did.
#pragma unroll kTileUnroll
    for (int tile = 0; tile < 2; ++tile) {
      if (!(tile ? shade1 : shade0)) continue;
      // The group's last reads of its features and activations (the
      // previous tile's) are done before the encode overwrites them.
      group_sync(c.wg);
      const int r0 = kWgRays * tile + 64 * c.wg;
      if constexpr (kStubChain)
        wg_tile_stub<Chain>(net, c, s_u + r0, s_v + r0, r0, io);
      else
        wg_tile<Chain>(net, c, s_u + r0, s_v + r0, r0, io);
    }
    consumers_sync();  // the head's outputs are visible; s_u, s_v are free again
    V3 tr = r.radiance;
    if (c.wg ? shade1 : shade0)  // direct + (bgr -> rgb flip times the escape weights)
      tr = tr + V3{r.esc_w.x * s_out[2 * kRaysPerBlock + tid],
                   r.esc_w.y * s_out[kRaysPerBlock + tid], r.esc_w.z * s_out[tid]};
    acc = acc + tr;
    if (lum2_out) {
      const float lum = kLumR * tr.x + kLumG * tr.y + kLumB * tr.z;
      acc_l2 = acc_l2 + lum * lum;
    }
    // The next sample writes its (u, v) only after every thread has passed
    // the barrier above (so the encodes are done), and its head outputs only
    // after the next one (so these reads are done).
  }
  consumers_sync();
  if (tid == 0) *ctl = kCtlDone;  // every slice the producer streamed for a tile is consumed
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

// Validates the plan (the chain's, and room for the scene's tables), then
// launches the model's chain (net.int8) in RNG mode kRng: one block of
// kWgThreads threads per kRaysPerBlock rays.
template <int kRng, int kStub>
int launch_megastep(const TraceParams& prm, const NifWg& net, const MegaArgs& a,
                    cudaStream_t stream) {
  if (a.budgets && (a.budget_block <= 0 || a.budget_block % kRaysPerBlock))
    return (int)cudaErrorInvalidValue;
  if (!wg_valid(net) ||
      mega_tables_offset(net) + (int)tables_bytes(prm) + kWgAlignSlack > net.smem_bytes)
    return (int)cudaErrorInvalidValue;
  void (*const kernel)(TraceParams, NifWg, const float*, const float*, const float*,
                       const float*, const float*, const int*, const int*, const int*, int, int,
                       int, int, float*, int*, float*) =
      net.int8 ? megastep_wg_kernel<kRng, kStub, true> : megastep_wg_kernel<kRng, kStub, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, net.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.n + kRaysPerBlock - 1) / kRaysPerBlock;
  if (blocks == 0) return 0;
  kernel<<<blocks, kWgThreads, net.smem_bytes, stream>>>(
      prm, net, a.sph, a.dsc, a.cols, a.rows, a.noise, a.pid, a.base, a.budgets, a.budget_block,
      a.samples, a.n, a.env_skip, a.rad, a.plen, a.lum2);
  return (int)cudaGetLastError();
}

}  // namespace pt
