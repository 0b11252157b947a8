// K3: the whole render step - for each of the step's samples, trace every
// ray of the block's rays (K1's device code) and shade its escape with the
// NIF (K2's device code), summing radiance and path length in registers.
//
// Replaces ipu_path_trace_tpu/ops/megastep_pallas.py::render_megastep_pallas
// (kernel body _kernel, :174).  One block owns kRaysPerBlock = 256 rays for
// the whole step, one ray per tracing thread, and shades the escapes of all
// its samples through one queue in shared memory, so neither the trace
// state nor the escape records nor the activations ever reach device
// memory: the step reads the pixel coordinates (and host noise, in that
// mode) and writes 4 words per ray (5 with the statistics).  One kernel,
// megastep_wg_kernel, on the wgmma chains of nif_wgmma.cuh - bf16, int8
// (K5, the s8 slices; the TPU kernel's quant branch) or f32 on TF32 wgmma
// (the TPU kernel with f32 weights) as its kOp parameter (operand bytes 2,
// 1, 4) says.  A block of kWgThreads = 384 threads: the 256 threads of the
// two consumer warpgroups each trace one ray and together shade the
// queue's tiles - kTile = 128 entries, either warpgroup holding 64 rows,
// or for the tf32 chain 64, both warpgroups on each, splitting its layers'
// outputs - and the producer warpgroup only streams weight slices.
//
// The escape queue: a ring of kMegaQueue = 384 entries in shared memory.
// An entry is one escape of one sample: its (u, v), its three escape
// weights and the luminance of its direct radiance, each an f32 in an
// array of 384, and its owner, the thread (so the ray) whose escape it is,
// one byte.  After each sample's trace every lane adds its direct radiance
// to its registers, and every lane with an escape (escape weights not all
// zero) appends one entry, at the place a warp ballot and the eight warps'
// counts give (lanes in thread order).  The capacity is what is left after
// shading (under a tile) plus a sample's entries (at most 256), so every
// entry is appended at once.  While the queue holds a full tile the block
// shades its oldest tile: its slots are contiguous, since the queue's head
// moves a tile at a time and 384 is a multiple of either tile, so the
// encode reads the (u, v) where they lie, and the head's store (MegaWgIo)
// turns each entry's weights into its env term: the bgr -> rgb flip of the
// outputs times the escape weights, as shading sample by sample gives it.
// After the tiles each lane scans their owner bytes, sixteen at a time
// (__vcmpeq4), and adds the env term of each entry it owns, in queue (so
// sample) order, to its registers; with the statistics, the square of the
// sample's luminance, the direct luminance plus the env term's (a sample
// that did not escape adds its direct luminance squared at once).  The pass
// after the last sample (the flush) shades what is left as one partial
// tile: its rows past the queue get (u, v) = 0 and their outputs are
// dropped, as are their owner bytes in the scan.  So only a block's last
// tile runs partly empty, every escape of every sample is shaded once, and
// a lane without an escape, which a shaded tile gave 0 * out = 0, is not
// queued: a block whose rays never escape runs no tile and reads no
// weights (the TPU kernel's _env_contrib guard, on every tile).  A row's
// chain does not depend on the row or tile that holds it, so each env term
// is the one shading sample by sample gives; a ray's f32 sums add the
// direct and env terms of its samples in another order.  The barriers of a pass: the
// trace's end (the counts are in), the entries' (every lane has read the
// counts, so the next sample may write them), and after the tiles, if any
// ran, their stores'.  The next appends overwrite shaded slots only after
// the next sample's first barrier, so after every scan.  After the role
// split the producer has returned, so each is a named barrier over the 256
// consumer threads (consumers_sync), never __syncthreads.
//
// The blocks are not persistent (one per 256 rays, one resident per SM by
// its shared memory and registers).  Which 256 rays a block takes (its ray
// block): without budgets, ray block blockIdx.x; with budgets, the
// launcher also passes order, the ray blocks by budget heaviest first
// (ties in index order, ops/megastep.py::block_order), and a ticket
// counter it zeroes on the stream, and thread 0 of each block takes ticket
// t = atomicAdd and publishes ray block order[t] in the control word's
// last int before the role split.  So the blocks that start first take
// the longest budgets whatever order the hardware hands out blockIdx in,
// and the short ones fill in behind them (longest-processing-time-first):
// an adaptive launch's last wave no longer waits on a heavy block that
// started late.  Every ray computes what it would under blockIdx.x (its
// noise is keyed by its index p), so the outputs are the same bit for bit.
// The first fill is lazy: the producer streams nothing until the consumers
// first shade a tile (kCtlGo), then the slice sequence tile after tile
// (wg_stream), and stops when the consumers say the block is done
// (kCtlDone).
// The kernel is instantiated per RNG mode (Philox, host noise, Owen-Sobol)
// and chain; the launcher picks by its arguments and the NifWg's int8
// and tf32 flags.  The other modes are runtime arguments:
//  * budgets (adaptive sampling): budgets[g] samples for the rays of
//    budget block g (budget_block rays, a multiple of kRaysPerBlock, so a
//    budget is uniform over a ray block, as the queue's block-wide
//    barriers and both warpgroups' consumption of every slice need).  It is
//    the sample-loop bound, 0 included; with host noise the loop also stops
//    at the noise's S rows, which gates rows >= budget to exact zeros as
//    the TPU kernel's multiplicative gate does.  A launch with budgets
//    dispatches its ray blocks heaviest budget first (order and ticket,
//    above); one without passes neither and maps blockIdx.x;
//  * lum2 != nullptr (with_stats): the sum over samples of the squared
//    Rec.709 luminance of each sample's radiance (direct + env; an escape's
//    squared where the scan finds its entry).
//
// What bounds it: the NIF chain, as on the TPU (nif_wgmma.cuh says what
// holds each chain; the weight slices, 1,111,040 B bf16 or 555,520 B int8
// per tile, do not), now on escapes alone, plus the trace's divergent
// per-ray loop; with one 384-thread block per SM, 8 warps per SM trace.
// The TPU kernel shades sample s - 1 during iteration s to overlap its
// matrix and vector units; here the chain runs between the traces (the
// producer prefetches the next tile's first slices during the trace).
//
// Shared memory (ops/megastep.py::megastep_wg_plan; the chain's plan with
// K3's tail after the barriers), canonical 6x320 net and the default scene
// (5 spheres, 1 disc):
//   bf16: activations 81,920 B, features 16,384 B, ring 3 stages x 40,960 B
//   = 122,880 B, barriers 64 B, then the tail: the queue's (u, v) 2 x 384 x
//   4 = 3,072 B, escape weights 3 x 384 x 4 = 4,608 B, direct luminance
//   1,536 B, owners 384 B, the warps' counts 8 x 4 = 32 B, control word
//   16 B (9,648 B), scene tables 304 B, 1,024-B alignment slack: 232,224
//   of the 232,448 B a block may use (64 B free with the 456 B of the
//   cornell_smallpt and mirror_hall tables).  The stages are as many as
//   fit (at most 4); 3 leave room for 528 B of tables (11 spheres), 2 for
//   41,488 B; a scene with more raises in the plan;
//   int8: activations 40,960 B, features 8,192 B, the skip layer's codes
//   32,768 B, ring 4 x 20,480 B, the tail as bf16: 174,880 B;
//   tf32 (64-ray tile): activations 10 atoms of 32 K values x 8,192 B =
//   81,920 B, features 2 x 8,192 B, ring 3 x 40,960 B (320 rows x 32
//   inputs x 4 B), the tail as bf16: 232,224 B, as bf16.
//
// The per-block record (stamps, nullable; ops/megastep.py passes a buffer
// only while a traced render loop runs, utils/tracing.py): each block
// writes kStampWords int64 at its ray block's row - its start, read from
// %globaltimer at entry before the role split, its end after its last
// store, its SM (%smid), the live lane-samples it ran, the lane-samples
// that escaped (nonzero escape weights) and the queue's tiles it shaded
// (the flush's partial tile included, so escapes / (tiles x kTile) reads
// how full the tiles ran), and three of the trace: thread 0's %globaltimer
// from each sample's start to the consumers' barrier that ends its trace,
// summed (the trace phase's ns); the lane-iterations the warps held, summed
// over warps and samples as 32 x the warp's most bounce iterations (a warp
// runs until its longest path ends); and the bounce iterations the lanes
// ran (trace_ray<.., kCount>).  The record is a template parameter
// (kRecord), like the stubs: launch_megastep picks the recording kernel
// for a non-null pointer, and the kernel without it compiles exactly as
// before the record existed.  In the recording kernel the escape tally is
// one register, summed into the record (zeroed by the launcher) at exit;
// thread 0 counts the tiles in the control word's second int and the
// trace's ns in one register; after each sample's trace each warp adds its
// most and its summed iterations to the control word's third and fourth
// ints (the fourth held the ray block, which every consumer has read by
// then).  The trace's three are 32-bit: exact while a block traces under
// 4.29 s and a launch takes under 1.6 M samples.  Held as registers across
// the sample loop, they spilled the int8 chain's recording kernels; added
// to the record in global memory every sample, the barrier that ends the
// trace waited on the atomics.
//
// The measurement stubs of --device-timing (utils/devtime.py) are a
// template parameter, so the production kernels (kStubNone, built by
// megastep.cu) compile exactly as without them; megastep_stub.cu builds
// the stubbed kernels.  kStubNif replaces the chain by wg_tile_stub (on
// the same queue tiles, with no weight copies and no MMAs), kStubTrace the
// bounce by trace_ray<true>'s stub, which escapes nowhere: there every
// live lane is queued (with zero escape weights), so the skeleton shades
// the block's live lane-samples, two tiles a sample.
#pragma once

#include "nif_wgmma.cuh"

namespace pt {

enum StubMode { kStubNone = 0, kStubNif = 1, kStubTrace = 2, kStubBoth = 3 };

constexpr int kRaysPerBlock = 2 * kWgRays;  // the two consumer warpgroups' threads
constexpr int kConsumerWarps = kRaysPerBlock / 32;

// Rec.709 luma weights (megastep_pallas.py LUM_R/G/B) for the statistics.
constexpr float kLumR = 0.2126f, kLumG = 0.7152f, kLumB = 0.0722f;

// K3's tail of the chain's plan, at net.smem_uv: the escape queue of
// kMegaQueue entries (its u, v, escape weights [3] and direct luminance as
// f32 arrays, then each entry's owner, one byte), the warps' counts of a
// sample's entries, the control word (WgCtl, 16 B: the control, the
// record's tiles and lane-iterations, the block's ray block, then the
// record's bounces), then the scene tables.  The queue holds what is left
// after shading (under a tile) and a sample's entries (at most 256).
constexpr int kMegaQueue = kWgRays + kRaysPerBlock;
constexpr int kMegaQueueBytes = kMegaQueue * (2 + 3 + 1) * 4 + kMegaQueue;
constexpr int kMegaCountBytes = kConsumerWarps * 4;
constexpr int kMegaCtlBytes = 16;
constexpr int kWgAlignSlack = 1024;  // the plan's slack for the 1024-byte alignment
// The per-block record's int64 words (utils/tracing.py STAMP_WORDS): start
// and end (ns), SM, live lane-samples, escaped lane-samples, tiles shaded,
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
  return net.smem_uv + kMegaQueueBytes + kMegaCountBytes + kMegaCtlBytes;
}

// The head's store into a queue tile of n entries (rows past n dropped):
// output o (network order) of row `row` times escape weight 2 - o (the
// bgr -> rgb flip), the entry's env term, in place of that weight.  w
// points at the tile's first slot of the [3][kMegaQueue] weights.
struct MegaWgIo {
  float* w;
  int n;
  PT_HD void store(int o, int row, float y) const {
    const int i = (2 - o) * kMegaQueue + row;
    if (row < n) w[i] = w[i] * y;
  }
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

static_assert(kWgConsumers == kRaysPerBlock && kRaysPerBlock <= 256 &&
                  kMegaQueue % kWgTileRays<2> == 0 && kMegaQueue % kWgTileRays<4> == 0,
              "a block's tracing threads are its two consumer warpgroups, each owner a "
              "byte; the queue's slots are whole tiles");

template <int kRng, int kStub, int kOp, bool kRecord>
__global__ void __launch_bounds__(kWgThreads, 1) megastep_wg_kernel(
    TraceParams prm, NifWg net, const float* __restrict__ sph_g, const float* __restrict__ dsc_g,
    const float* __restrict__ cols, const float* __restrict__ rows,
    const float* __restrict__ noise, const int* __restrict__ pid, const int* __restrict__ base,
    const int* __restrict__ budgets, const int* __restrict__ order, int* __restrict__ ticket,
    int budget_block, int samples, int n, float* __restrict__ rad_out,
    int* __restrict__ plen_out, float* __restrict__ lum2_out, long long* __restrict__ stamps) {
  using Chain = NifChain<kOp>;
  constexpr bool kStubChain = (kStub & kStubNif) != 0;
  constexpr bool kStubBounce = (kStub & kStubTrace) != 0;
  constexpr int kTile = kWgTileRays<kOp>;
  const WgBlock b = wg_block(net);
  float* const s_u = (float*)(b.smem + net.smem_uv);
  float* const s_v = s_u + kMegaQueue;
  float* const s_w = s_v + kMegaQueue;  // [3][kMegaQueue] escape weights, then env terms
  float* const s_lum = s_w + 3 * kMegaQueue;  // the direct radiance's luminance
  unsigned char* const s_owner = (unsigned char*)(s_lum + kMegaQueue);
  int* const s_count = (int*)(s_owner + kMegaQueue);  // a sample's entries, per consumer warp
  volatile int* const ctl = (volatile int*)(s_count + kConsumerWarps);
  // The record's block-wide tallies, beside the control word: tiles
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

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rb = *s_block;
  const int p = rb * kRaysPerBlock + tid;
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
  // The queue (header comment), block-uniform: its oldest entry's slot (a
  // multiple of kTile) and its entries.
  int head = 0, queued_n = 0;

  // Pass s < n_samples traces sample s; pass n_samples is the flush.
  for (int s = 0; s <= n_samples; ++s) {
    const bool flush = s == n_samples;
    if (!flush) {
      if constexpr (kRecord)
        if (tid == 0) trace_ns -= (unsigned)global_ns();
      TraceResult r;
      r.radiance = r.esc_dir = r.esc_w = V3{0.f, 0.f, 0.f};
      r.path_len = 0;
      int iters = 0;
      if (live) {
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
      acc = acc + r.radiance;
      const float lum = kLumR * r.radiance.x + kLumG * r.radiance.y + kLumB * r.radiance.z;
      const bool escapes = r.esc_w.x != 0.0f || r.esc_w.y != 0.0f || r.esc_w.z != 0.0f;
      if constexpr (kRecord) acc_esc += escapes;
      // The stubbed bounce escapes nowhere: its skeleton queues every live lane.
      const bool queued = kStubBounce ? live : escapes;
      if (lum2_out && !queued) acc_l2 = acc_l2 + lum * lum;
      const unsigned ballot = __ballot_sync(0xffffffffu, queued);
      if (lane == 0) s_count[warp] = __popc(ballot);
      consumers_sync();  // every lane's trace has ended; the counts are in
      if constexpr (kRecord) {
        if (tid == 0) trace_ns += (unsigned)global_ns();
        const unsigned most = __reduce_max_sync(0xffffffffu, (unsigned)iters);
        const unsigned sum = __reduce_add_sync(0xffffffffu, (unsigned)iters);
        if (lane == 0) {
          atomicAdd(s_lane_iters, 32u * most);
          atomicAdd(s_bounces, sum);
        }
      }
      int rank = __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        const int k = s_count[w];
        rank += w < warp ? k : 0;
        total += k;
      }
      if (queued) {  // append this lane's entry
        int slot = head + queued_n + rank;
        slot -= slot >= kMegaQueue ? kMegaQueue : 0;
        equirect_uv(r.esc_dir.x, r.esc_dir.y, r.esc_dir.z, prm.azimuth, &s_u[slot], &s_v[slot]);
        s_w[slot] = r.esc_w.x;
        s_w[kMegaQueue + slot] = r.esc_w.y;
        s_w[2 * kMegaQueue + slot] = r.esc_w.z;
        s_lum[slot] = lum;
        s_owner[slot] = (unsigned char)tid;
      }
      queued_n += total;
    } else if (queued_n) {  // the partial tile's rows past the queue
      for (int i = queued_n + tid; i < kTile; i += kWgConsumers)
        s_u[head + i] = s_v[head + i] = 0.0f;
    }
    // The full tiles; after the last sample, what is left as one partial tile.
    consumers_sync();  // the entries are in; every lane has read the counts
    const int tiles = flush ? (queued_n > 0) : queued_n / kTile;
    if (tiles == 0) continue;
    if (!kStubChain && tid == 0) *ctl = kCtlGo;
    if constexpr (kRecord)
      if (tid == 0) *s_passes += tiles;
    auto next_tile = [](int slot) { return slot + kTile == kMegaQueue ? 0 : slot + kTile; };
    for (int t = 0, slot = head; t < tiles; ++t, slot = next_tile(slot)) {
      const int r0 = wg_row0<kOp>(c.wg);
      const MegaWgIo io{s_w + slot, min(kTile, queued_n - t * kTile)};
      // The last reads of the features and activations (the previous
      // tile's) are done before the encode overwrites them.
      wg_sync<kOp>(c.wg);
      if constexpr (kStubChain)
        wg_tile_stub<Chain>(net, c, s_u + slot + r0, s_v + slot + r0, r0, io);
      else
        wg_tile<Chain>(net, c, s_u + slot + r0, s_v + slot + r0, r0, io);
    }
    consumers_sync();  // the tiles' env terms are in
    // This lane's shaded entries, in queue (so sample) order: a scan of the
    // tiles' owner bytes, sixteen at a time.
    const uint32_t me = 0x01010101u * (uint32_t)tid;
    for (int t = 0, slot = head; t < tiles; ++t, slot = next_tile(slot)) {
      const int rows_t = min(kTile, queued_n - t * kTile);
#pragma unroll 1
      for (int k = 0; k < kTile / 16; ++k) {
        const uint4 o = reinterpret_cast<const uint4*>(s_owner + slot)[k];
        const uint32_t words[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t m = __vcmpeq4(words[j], me);  // 0xff in each byte this lane owns
          while (m) {
            const int byte = (__ffs(m) - 1) >> 3, row = 16 * k + 4 * j + byte;
            m &= ~(0xffu << (8 * byte));
            if (row >= rows_t) continue;  // past a partial tile's entries
            const int at = slot + row;
            const V3 env = {s_w[at], s_w[kMegaQueue + at], s_w[2 * kMegaQueue + at]};
            acc = acc + env;
            if (lum2_out) {
              const float l = s_lum[at] + (kLumR * env.x + kLumG * env.y + kLumB * env.z);
              acc_l2 = acc_l2 + l * l;
            }
          }
        }
      }
    }
    head += tiles * kTile;
    head -= head >= kMegaQueue ? kMegaQueue : 0;
    queued_n = flush ? 0 : queued_n - tiles * kTile;
  }
  // Every tile ended before one of the loop's barriers, so every slice the
  // producer streamed for a tile is consumed.
  if (tid == 0) *ctl = kCtlDone;
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
    if (lane == 0) atomicAdd((unsigned long long*)&rec[4], (unsigned long long)warp_esc);
    consumers_sync();  // every store, every warp's escapes and the last sample's tallies are in
    if (tid == 0) {
      rec[1] = global_ns();
      rec[3] = (long long)min(n - rb * kRaysPerBlock, kRaysPerBlock) * n_samples;
      rec[5] = *s_passes;
      rec[6] = trace_ns;
      rec[7] = *s_lane_iters;
      rec[8] = *s_bounces;
    }
  }
}

// K3's launch arguments past the TraceParams and the NifWg, as pt_megastep
// takes them (megastep.cu); ops/_lib.py::MegaArgs mirrors them field for
// field.  The launcher unpacks them into the kernel's parameters.
struct MegaArgs {
  const float *sph, *dsc, *cols, *rows, *noise;
  const int *pid, *base, *budgets;
  const int* order;  // the ray blocks heaviest budget first, or nullptr
  int* ticket;       // one int the launch zeroes, with order
  int budget_block, samples, n;
  float* rad;
  int* plen;
  float* lum2;
  long long* stamps;  // the per-block records, or nullptr
};

using MegaKernel = void (*)(TraceParams, NifWg, const float*, const float*, const float*,
                            const float*, const float*, const int*, const int*, const int*,
                            const int*, int*, int, int, int, float*, int*, float*, long long*);

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
      a.ticket, a.budget_block, a.samples, a.n, a.rad, a.plen, a.lum2, a.stamps);
  return (int)cudaGetLastError();
}

// launch_megastep with measurement stub kStubNif, kStubTrace or kStubBoth,
// in Sobol mode for a non-null a.pid, else Philox (megastep_stub.cu, their
// own translation unit); the stubs take no host noise and ignore a.stamps.
// cudaErrorInvalidValue for any other stub or with a.noise.
int launch_megastep_stub(const TraceParams& prm, const NifWg& net, const MegaArgs& a, int stub,
                         cudaStream_t stream);

}  // namespace pt
