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
// on the wgmma chains of nif_wgmma.cuh - bf16, int8 (K5, the s8 slices;
// the TPU kernel's quant branch) or f32 on TF32 wgmma (the TPU kernel with
// f32 weights) as its kOp parameter (operand bytes 2, 1, 4) says.  A block
// of kWgThreads = 384 threads: the 256 threads of the two consumer
// warpgroups each trace one ray, then the sample's 256 escapes are shaded
// as two 128-ray wgmma tiles (rays 0-127, then 128-255; in each, either
// warpgroup holds 64 rows) or, for the tf32 chain, four 64-ray tiles (both
// warpgroups on each, splitting its layers' outputs), and the producer
// warpgroup only streams weight slices.
// Each tracing thread keeps its ray's escape weights and direct radiance in
// registers; only the (u, v) of the escapes and the head's decoded outputs
// go through shared memory.  After the role split the producer has
// returned, so every barrier of the loop is a named one over the 256
// consumer threads (consumers_sync), never __syncthreads.  The blocks are
// not persistent (one per 256 rays, one resident per SM by its shared
// memory and registers).  Which 256 rays a block takes (its ray block):
// without budgets, ray block blockIdx.x; with budgets, the launcher also
// passes order, the ray blocks by budget heaviest first (ties in index
// order, ops/megastep.py::block_order), and a ticket counter it zeroes on
// the stream, and thread 0 of each block takes ticket t = atomicAdd and
// publishes ray block order[t] in the control word's last int before the
// role split.  So the blocks that start first take the longest budgets
// whatever order the hardware hands out blockIdx in, and the short ones
// fill in behind them (longest-processing-time-first): an adaptive
// launch's last wave no longer waits on a heavy block that started late.
// Every ray computes what it would under blockIdx.x (its noise is keyed by
// its index p), so the outputs are the same bit for bit.  The first fill is
// lazy: the producer streams
// nothing until the consumers first ask for a tile (kCtlGo), then the
// slice sequence tile after tile (wg_stream), and stops when the consumers
// say the block is done (kCtlDone), so a block whose tiles are all skipped
// reads no weights.
// The kernel is instantiated per RNG mode (Philox, host noise, Owen-Sobol)
// and chain; the launcher picks by its arguments and the NifWg's int8
// flag.  The other modes are runtime arguments:
//  * budgets (adaptive sampling): budgets[g] samples for the rays of
//    budget block g (budget_block rays, a multiple of kRaysPerBlock, so a
//    budget is uniform over a ray block, as the chain's block-wide
//    barriers and both warpgroups' consumption of every slice need).  It is
//    the sample-loop bound, 0 included; with host noise the loop also stops
//    at the noise's S rows, which gates rows >= budget to exact zeros as
//    the TPU kernel's multiplicative gate does.  A launch with budgets
//    dispatches its ray blocks heaviest budget first (order and ticket,
//    above); one without passes neither and maps blockIdx.x;
//  * lum2 != nullptr (with_stats): the sum over samples of the squared
//    Rec.709 luminance of each sample's radiance (direct + env);
//  * env_skip: a wgmma tile (128 rays; 64 for tf32) whose escape weights
//    are all zero skips the chain (ops/megastep.py::env_skip_tile); its
//    contribution would be exact zeros, so the result does not change (the
//    TPU kernel's _env_contrib guard, at tile granularity).  A tile with no live ray
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
//   32,768 B, ring 4 x 20,480 B, the tail as bf16: 170,368 B;
//   tf32 (64-ray tile): activations 10 atoms of 32 K values x 8,192 B =
//   81,920 B, features 2 x 8,192 B, ring 3 x 40,960 B (320 rows x 32
//   inputs x 4 B), the tail as bf16: 227,712 B, as bf16.
//
// The per-block record (stamps, nullable; ops/megastep.py passes a buffer
// only while a traced render loop runs, utils/tracing.py): each block
// writes kStampWords int64 at its ray block's row - its start, read from
// %globaltimer at entry
// before the role split, its end after its last store, its SM (%smid), the
// live lane-samples it ran, the lane-samples that escaped (nonzero escape
// weights) and the chain tile passes it ran (a tile env_skip skipped does
// not count), and three of the trace: thread 0's %globaltimer from each
// sample's start to the consumers' barrier that ends its trace, summed
// (the trace phase's ns); the lane-iterations the warps held, summed over
// warps and samples as 32 x the warp's most bounce iterations (a warp runs
// until its longest path ends); and the bounce iterations the lanes ran
// (trace_ray<.., kCount>).  The record is a template parameter (kRecord), like the
// stubs: launch_megastep picks the recording kernel for a non-null
// pointer, and the kernel without it compiles exactly as before the record
// existed.  In the recording kernel the escape tally is one register,
// summed into the record (zeroed by the launcher) at exit; thread 0 counts
// the tile passes in the control word's second int and the trace's ns in
// one register; after each sample's trace each warp adds its most and its
// summed iterations to the control word's third and fourth ints (the
// fourth held the ray block, which every consumer has read by then).  The
// trace's three are 32-bit: exact while a block traces under 4.29 s and a
// launch takes under 1.6 M samples.  Held as registers across the sample
// loop, they spilled the int8 chain's recording kernels; added to the
// record in global memory every sample, the barrier that ends the trace
// waited on the atomics.
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

constexpr int kRaysPerBlock = 2 * kWgRays;  // two 128-ray wgmma tiles, or four of 64

// Rec.709 luma weights (megastep_pallas.py LUM_R/G/B) for the statistics.
constexpr float kLumR = 0.2126f, kLumG = 0.7152f, kLumB = 0.0722f;

// K3's tail of the chain's plan, at net.smem_uv: the block's u[256] and
// v[256], the head's outputs [3][256] (network order), the control word
// (WgCtl, 16 B: the control, the record's tile passes and lane-iterations,
// the block's ray block, then the record's bounces), then the scene tables.
constexpr int kMegaUvBytes = 2 * kRaysPerBlock * 4;
constexpr int kMegaOutBytes = 3 * kRaysPerBlock * 4;
constexpr int kMegaCtlBytes = 16;
constexpr int kWgAlignSlack = 1024;  // the plan's slack for the 1024-byte alignment
// The per-block record's int64 words (utils/tracing.py STAMP_WORDS): start
// and end (ns), SM, live lane-samples, escaped lane-samples, tile passes,
// trace ns, trace lane-iterations, trace bounces.
constexpr int kStampWords = 9;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__device__ __forceinline__ int sm_id() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return (int)s;
}

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

static_assert(kWgConsumers == kRaysPerBlock && kRaysPerBlock % kWgTileRays<4> == 0,
              "a block's tracing threads are its two consumer warpgroups, its rays whole tiles");

template <int kRng, int kStub, int kOp, bool kRecord>
__global__ void __launch_bounds__(kWgThreads, 1) megastep_wg_kernel(
    TraceParams prm, NifWg net, const float* __restrict__ sph_g, const float* __restrict__ dsc_g,
    const float* __restrict__ cols, const float* __restrict__ rows,
    const float* __restrict__ noise, const int* __restrict__ pid, const int* __restrict__ base,
    const int* __restrict__ budgets, const int* __restrict__ order, int* __restrict__ ticket,
    int budget_block, int samples, int n, int env_skip,
    float* __restrict__ rad_out, int* __restrict__ plen_out, float* __restrict__ lum2_out,
    long long* __restrict__ stamps) {
  using Chain = NifChain<kOp>;
  constexpr bool kStubChain = (kStub & kStubNif) != 0;
  constexpr int kTile = kWgTileRays<kOp>, kTiles = kRaysPerBlock / kTile;
  constexpr int kTileUnroll = kStub == kStubNone || kWgSplit<kOp> ? 1 : 2;
  const WgBlock b = wg_block(net);
  float* const s_u = (float*)(b.smem + net.smem_uv);
  float* const s_v = s_u + kRaysPerBlock;
  float* const s_out = s_v + kRaysPerBlock;
  volatile int* const ctl = (volatile int*)(s_out + 3 * kRaysPerBlock);
  // The record's block-wide tallies, beside the control word: tile passes
  // (thread 0 alone), the trace's lane-iterations and bounces.
  volatile int* const s_passes = ctl + 1;
  unsigned* const s_lane_iters = (unsigned*)(ctl + 2);
  unsigned* const s_bounces = (unsigned*)(ctl + 3);
  // The block's ray block, written once by thread 0 before the barrier.
  int* const s_block = (int*)(ctl + 3);
  float* const s_tables = (float*)(b.smem + mega_tables_offset(net));
  if (threadIdx.x == 0) {
    long long start = 0;
    if constexpr (kRecord) start = global_ns();
    const int rb = order ? order[atomicAdd(ticket, 1)] : (int)blockIdx.x;
    *s_block = rb;
    if constexpr (kRecord) {
      stamps[(long long)rb * kStampWords] = start;
      stamps[(long long)rb * kStampWords + 2] = sm_id();
    }
  }
  wg_setup(net, b);
  if (threadIdx.x == 0) {
    *ctl = kCtlIdle;
    if constexpr (kRecord) {
      *s_passes = 0;
      *s_lane_iters = 0;
    }
  }
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
  WgConsumer c = wg_consumer<kOp>(net, b);
  const float* sph = s_tables;
  const float* dsc = s_tables + prm.num_s * kSphereF;
  const MegaWgIo io{s_out, kRaysPerBlock};

  const int tid = threadIdx.x;
  const int rb = *s_block;
  const int p = rb * kRaysPerBlock + tid;
  const bool live = p < n;  // the ragged tail still joins every barrier
  const int block_rays = n - rb * kRaysPerBlock;  // past kRaysPerBlock: all live
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
    const int bud = budgets[(rb * kRaysPerBlock) / budget_block];
    n_samples = kRng == kRngHost ? min(bud, samples) : bud;
  }
  V3 acc = {0.0f, 0.0f, 0.0f};
  int acc_len = 0;
  float acc_l2 = 0.0f;
  int acc_esc = 0;  // the record's escaped lane-samples (a dead lane's weights are zero)
  unsigned trace_ns = 0;  // thread 0: the record's trace-phase ns
  if constexpr (kRecord) {
    consumers_sync();  // every consumer has read the ray block: its int takes the bounces
    if (tid == 0) *s_bounces = 0;
  }

  for (int s = 0; s < n_samples; ++s) {
    if constexpr (kRecord)
      if (tid == 0) trace_ns -= (unsigned)global_ns();
    TraceResult r;
    r.radiance = r.esc_dir = r.esc_w = V3{0.f, 0.f, 0.f};
    r.path_len = 0;
    int iters = 0;
    if (live) {
      constexpr bool kStubBounce = (kStub & kStubTrace) != 0;
      if constexpr (kRng == kRngHost)
        r = trace_ray<kStubBounce, kRecord>(
            prm, sph, dsc, col, row, HostNoise{noise + s * sample_stride + p, (long long)n},
            &iters);
      else if constexpr (kRng == kRngSobol)
        r = trace_ray<kStubBounce, kRecord>(
            prm, sph, dsc, col, row,
            SobolNoiseK3(sobol_noise(prm, pixel, seq0 + (uint32_t)s, (uint32_t)p, (uint32_t)s)),
            &iters);
      else
        r = trace_ray<kStubBounce, kRecord>(
            prm, sph, dsc, col, row, PhiloxNoise{prm.seed0, prm.seed1, (uint32_t)p, (uint32_t)s},
            &iters);
    }
    acc_len += r.path_len;
    equirect_uv(r.esc_dir.x, r.esc_dir.y, r.esc_dir.z, prm.azimuth, &s_u[tid], &s_v[tid]);
    // Which tiles to shade (bit t, block-uniform): tile t holds the rays of
    // threads kTile t.. kTile (t + 1) - 1 (a warpgroup's on the 128-ray
    // tile).  A tile with no live ray is skipped.  The barriers also
    // publish the (u, v).
    uint32_t shade = 0u;
    const bool escapes = r.esc_w.x != 0.0f || r.esc_w.y != 0.0f || r.esc_w.z != 0.0f;
    if constexpr (kRecord) acc_esc += escapes;
    if (env_skip) {
#pragma unroll
      for (int t = 0; t < kTiles; ++t)
        shade |= (uint32_t)(consumers_or(tid / kTile == t && escapes) && block_rays > kTile * t)
                 << t;
    } else {
      consumers_sync();
#pragma unroll
      for (int t = 0; t < kTiles; ++t) shade |= (uint32_t)(block_rays > kTile * t) << t;
    }
    if constexpr (kRecord)  // every lane's trace ended before these barriers
      if (tid == 0) trace_ns += (unsigned)global_ns();
    if (!kStubChain && tid == 0 && shade) *ctl = kCtlGo;
    if constexpr (kRecord) {
      if (tid == 0) *s_passes += __popc(shade);
      const unsigned most = __reduce_max_sync(0xffffffffu, (unsigned)iters);
      const unsigned sum = __reduce_add_sync(0xffffffffu, (unsigned)iters);
      if ((tid & 31) == 0) {
        atomicAdd(s_lane_iters, 32u * most);
        atomicAdd(s_bounces, sum);
      }
    }
    // The loop is unrolled in the stubs and not in the production kernels:
    // so ptxas allocates every instantiation without spills at 240
    // registers (chip_smoke.py's ptxas phase), which neither choice alone did.
#pragma unroll kTileUnroll
    for (int tile = 0; tile < kTiles; ++tile) {
      if (!((shade >> tile) & 1u)) continue;
      // The last reads of the features and activations (the previous
      // tile's) are done before the encode overwrites them.
      wg_sync<kOp>(c.wg);
      const int r0 = kTile * tile + wg_row0<kOp>(c.wg);
      if constexpr (kStubChain)
        wg_tile_stub<Chain>(net, c, s_u + r0, s_v + r0, r0, io);
      else
        wg_tile<Chain>(net, c, s_u + r0, s_v + r0, r0, io);
    }
    consumers_sync();  // the head's outputs are visible; s_u, s_v are free again
    V3 tr = r.radiance;
    if ((shade >> (tid / kTile)) & 1u)  // direct + (bgr -> rgb flip times the escape weights)
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
  if constexpr (kRecord) {
    long long* const rec = stamps + (long long)rb * kStampWords;
    const unsigned warp_esc = __reduce_add_sync(0xffffffffu, (unsigned)acc_esc);
    if ((tid & 31) == 0) atomicAdd((unsigned long long*)&rec[4], (unsigned long long)warp_esc);
    consumers_sync();  // every store, every warp's escapes and the last sample's tallies are in
    if (tid == 0) {
      rec[1] = global_ns();
      rec[3] = (long long)min(block_rays, kRaysPerBlock) * n_samples;
      rec[5] = *s_passes;
      rec[6] = trace_ns;
      rec[7] = *s_lane_iters;
      rec[8] = *s_bounces;
    }
  }
}

struct MegaArgs {
  const float *sph, *dsc, *cols, *rows, *noise;
  const int *pid, *base, *budgets;
  const int* order;  // the ray blocks heaviest budget first, or nullptr
  int* ticket;       // one int the launch zeroes, with order
  int budget_block, samples, n, env_skip;
  float* rad;
  int* plen;
  float* lum2;
  long long* stamps;  // the per-block records, or nullptr
};

using MegaKernel = void (*)(TraceParams, NifWg, const float*, const float*, const float*,
                            const float*, const float*, const int*, const int*, const int*,
                            const int*, int*, int, int, int, int, float*, int*, float*,
                            long long*);

// The model's chain (net.int8, net.tf32).
template <int kRng, int kStub, bool kRecord>
MegaKernel mega_kernel(const NifWg& net) {
  return net.int8   ? megastep_wg_kernel<kRng, kStub, 1, kRecord>
         : net.tf32 ? megastep_wg_kernel<kRng, kStub, 4, kRecord>
                    : megastep_wg_kernel<kRng, kStub, 2, kRecord>;
}

// Validates the plan (the chain's, and room for the scene's tables), then
// launches the model's chain in RNG mode kRng: one block of kWgThreads
// threads per kRaysPerBlock rays; the recording kernel for a non-null
// a.stamps (built for kStubNone alone: a stub's stamps are ignored).  With
// a.order it zeroes a.ticket on the stream first.
template <int kRng, int kStub>
int launch_megastep(const TraceParams& prm, const NifWg& net, const MegaArgs& a,
                    cudaStream_t stream) {
  if (a.budgets && (a.budget_block <= 0 || a.budget_block % kRaysPerBlock))
    return (int)cudaErrorInvalidValue;
  if (a.order && (!a.budgets || !a.ticket)) return (int)cudaErrorInvalidValue;
  if (!wg_valid(net) ||
      mega_tables_offset(net) + (int)tables_bytes(prm) + kWgAlignSlack > net.smem_bytes)
    return (int)cudaErrorInvalidValue;
  MegaKernel kernel = mega_kernel<kRng, kStub, false>(net);
  if constexpr (kStub == kStubNone)
    if (a.stamps) kernel = mega_kernel<kRng, kStub, true>(net);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, net.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.n + kRaysPerBlock - 1) / kRaysPerBlock;
  if (blocks == 0) return 0;
  if (a.order && (err = cudaMemsetAsync(a.ticket, 0, sizeof(int), stream)) != cudaSuccess)
    return (int)err;
  kernel<<<blocks, kWgThreads, net.smem_bytes, stream>>>(
      prm, net, a.sph, a.dsc, a.cols, a.rows, a.noise, a.pid, a.base, a.budgets, a.order,
      a.ticket, a.budget_block, a.samples, a.n, a.env_skip, a.rad, a.plen, a.lum2, a.stamps);
  return (int)cudaGetLastError();
}

}  // namespace pt
