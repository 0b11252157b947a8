// The NIF chains on Hopper's warpgroup MMA, for K2 and K4 (nif.cu), K3
// (megastep.cuh) and the probes K6 and K7 (probes.cu) and K8 (quant_probe.cu):
// encode -> layers -> decode for tiles of kWgRays rays, the weights
// streamed through shared memory by bulk copies.  The chains share the
// tile, the ring and the slice sequence; a chain policy (ChainBf16,
// ChainInt8, K8's ChainK8 and ChainK8Wide) gives the operand width and MMA
// (kInt8: 1-byte operands, the s8 tile, s8 wgmma; else bf16) and the
// epilogue (kNarrow: K8's on the bf16 tile):
//  * bf16 (ChainBf16): what models/nif.nif_apply computes - encode_bf16's
//    direct sincosf angles, bf16 weights and activations with f32
//    accumulation, f32 bias, ReLU and a round to bf16 between layers, the
//    skip layer's concat(trunk, feats) as the tail of its K dimension, the
//    f32 decode y * max + mean (exp when log-tone-mapped) - in another order
//    of f32 sums;
//  * int8 (ChainInt8, K5: replaces ops/nif_pallas.py::_quant_mlp_core; the
//    arithmetic is models/quant.quant_layer_t): Fourier features as codes
//    clip(rint(f * 127), +-127), s8 x s8 -> s32 wgmma, then in f32 and in
//    the reference's order y = acc * mult (+ accf * mult_skip) + b, ReLU,
//    clip(rint(y * inv_next) - 128, -128, 127) as the next layer's s8
//    codes, the head's f32 decode.  Integer sums are exact in any order and
//    --fmad=false keeps each f32 product and sum apart, so the chain equals
//    its plain version bit for bit.  The skip layer's trunk and feature
//    dots have two multipliers, so two accumulator sets (wg_skip);
//  * K8's fp8 variants: the e4m3 codes' bf16 values (exact) on the bf16
//    tile (ChainK8Wide: HGMMA, f32 sums; the skip layer's two dots by
//    wg_skip_wide).  Not e4m3 wgmma (QGMMA): its sums keep only part of
//    their bits and break K8's fp8 budget (PERF.md;
//    probes/fp8_qgmma.py rebuilds and measures that route).
// A layer hook (wg_layers' hook, WgNoHook in K2, K3, K4 and K8) runs in
// every consumer thread once per layer, after the layer's last wgmma is
// issued and before the wait for it, so that its work overlaps the tensor
// cores' (K6 'both' and K7 run their ALU rounds there).
//
// The pieces, in the order a kernel calls them: wg_block and wg_setup (the
// plan's shared memory, the ring's barriers, the features' zero columns),
// then the role split wg_producer_role (setmaxnreg; the producer thread
// runs a WgProducer), then per tile wg_tile (encode from the tile's (u, v),
// the layers, the head storing through an Io).  K2, K4, K6, K7 and K8 walk
// a fixed list of tiles (wg_tiles; K2, K4 and K8 through nif_wg_tiles, whose
// K8 Io hands precomputed features in place of the encode; K6 puts its own
// features and adds its ALU value after the head; K7 runs its loop's
// iterations as passes of the chain over one tile); K3 decides per sample
// which tiles to shade and streams them through wg_stream (megastep.cuh
// says how).
//
// Why: the mma.sync chains that came first ran 64-ray tiles whose warps load
// their B fragments from L2 with 4-byte __ldg's, so each 64-ray tile reads
// all the weights from L2 and the warps mostly wait on it (~12% of dense
// bf16 peak).  Here a tile is 128 rays, the weights arrive in 64-input
// K-slices by cp.async.bulk into a ring in shared memory, and wgmma (the
// only route to Hopper's full tensor-core rate) reads both operands there.
//
// Roles (kWgThreads = 384): two consumer warpgroups, each owning 64 rays of
// the tile (wgmma's M), and a producer warpgroup one thread of which walks
// the same slice sequence (layer by layer, tile after tile: in K2 and K4
// the block is persistent over tiles blockIdx.x + i * gridDim.x) and keeps
// the ring's `stages` slices filled: full[s] completes on the bulk copy's bytes,
// empty[s] on one arrival per consumer warp once its MMAs on the slice have
// completed.  A consumer issues a slice's MMAs while the previous slice's
// are still in flight (wgmma.wait_group 1), so it holds two stages.
// Per K step (16 bf16 or 32 8-bit values: 32 bytes) a hidden layer of NC
// 64-wide output chunks is one wgmma of N = 64 min(NC, 4) plus, for a
// fifth chunk, one of N = 64; the head is one of N = 8 (outputs padded to 8).
//
// Layouts: every wgmma operand is K-major; a row holds 64 K values - 128
// bytes of bf16 under the 128-byte swizzle, 64 bytes of s8 under the
// 64-byte swizzle - and an "atom" is that row for a set of rows.  16-byte
// chunk c of row r sits at chunk c ^ (r % 8) (128-byte) or c ^ ((r / 2) %
// 4) (64-byte) of the row (wg_offset), 8-row groups 8 rows apart (the
// descriptor's stride offset: 1024 or 512 bytes), and the K steps inside
// an atom advance the descriptor by 32 bytes.
//   * weights: a slice is one layer's rows (outputs, padded to 64 for a
//     hidden layer, to 8 for the head) x 64 inputs, packed on the host into
//     exactly this image (ops/nif.py::wgmma_operands), so one copy of
//     rows * row bytes fills a stage.  Input columns past the layer's
//     fan-in are zero;
//   * activations: [atom][128 rays][row], updated in place: a warpgroup
//     reads only its own 64 rows as A, and it overwrites them with the
//     layer's outputs after its last wgmma of the layer has completed,
//     holding all of a layer's outputs (up to 320) as 160 accumulators per
//     thread;
//   * features: their own atoms, written by the encode, the columns from
//     4E up zeroed once per block.  Layer 0 reads them as its input, the
//     skip layer as the slices after its trunk slices.
// Each layer's K is its fan-in rounded up to 64: the padded weight columns
// are zero, so whatever the activations hold there adds nothing (the bf16
// epilogue writes zeros for the padded outputs, which have zero weights,
// bias and multipliers; the int8 one writes the code of 0, -128).
//
// Why the 64-byte swizzle for s8 (not 128-byte rows of 128 K values): it
// keeps the bf16 chain's slice sequence (64-input slices, the same atoms
// and chunks, 2 K steps of 32 per slice in place of 4 of 16), so one plan
// and one producer serve both chains, and it reads fewer bytes - 555,520 B
// of slices per canonical tile (0.50x bf16's 1,111,040) against 699,392 B
// (0.63x), because 320 inputs pad to 384 in 128-value rows; wgmma s8 runs
// at the full int8 rate from it (measured: PERF.md).
//
// The 8-bit skip layer (wg_skip): both accumulator sets of 320 outputs
// would be 2 x 160 registers per consumer thread, past kWgConsumerRegs.  So it
// runs as passes over kWgPassRows = 128 outputs at a time (3 for 320
// outputs: rows 0-127, 128-255, 256-319), at most 2 x 64 accumulators, so
// the skip layer never holds more than a hidden layer.  Each pass's rows of
// a slice are contiguous in the rows x 64-byte image, so the producer
// copies those rows for that layer (NifWg::passes) and no weight byte is
// read twice.  The codes of every pass but the last wait in shared memory
// (the plan's codes area, 32,768 B for 320 outputs) until the last pass has
// read the trunk; held in registers they spilled.
//
// Shared-memory plan of K2 and K4, canonical 6x320 net (E = 12), computed
// in ops/nif.py::wgmma_plan and carried here in NifWg (K3's, with its own
// tail after the barriers, is in megastep.cuh):
//   bf16: activations 5 atoms x 16,384 B = 81,920 B, features 16,384 B,
//   ring 3 stages x 40,960 B (320 rows x 128 B) = 122,880 B, barriers 64 B,
//   (u, v) 1,024 B, 1,024-B alignment slack: 223,296 B of the 232,448 a
//   block may use, so one block per SM;
//   int8: activations 5 x 8,192 B, features 8,192 B, the skip layer's
//   codes 32,768 B, ring 4 x 20,480 B, the rest as bf16: 165,952 B.
// Registers: a block of 384 threads starts at 168 per thread (65,536 /
// 384, rounded down to 8); the producer warpgroup gives its surplus back
// (setmaxnreg.dec to kWgProducerRegs = 24, what its one thread's copy loop
// needs) and the consumers take it (setmaxnreg.inc to kWgConsumerRegs =
// 240: 128 x 24 + 256 x 240 = 64,512, the block's 384 x 168), room for the
// 160 accumulators and the epilogue's loads.  At 40 / 232 the int8 chain's
// epilogue spilled in K3 and K8, and which kernel spilled moved with small
// edits: the margin was a few registers.  With a single producer warp
// ptxas still sizes the block as three warpgroups and, held to 168
// registers, spills the accumulators.
// What bounds it (PERF.md, measured on the H100 by ablation): not the
// weight stream - a 128-ray tile reads its slices once, 1,111,040 B bf16
// or 555,520 B int8 for the canonical net, and with the copies removed the
// kernels run as fast.  The bf16 chain's MMA phases run at about the bf16
// tensor peak; the rest is its epilogue and the trace.  The int8 chain's
// MMA phases run at about half the int8 peak - a slice holds only 2 K steps
// of MMAs, too little to hide each slice's round trip - and its epilogue
// (the f32 requant of every output) costs about as much as its MMAs.
//
// A wait on an mbarrier traps after ~2^34 clocks (seconds) instead of
// hanging the card, should a phase ever be missed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "nif_dev.cuh"

namespace pt {

constexpr int kWgRays = 128;  // rays per tile (block)
constexpr int kWgGroups = 2;  // consumer warpgroups, 64 rays each
constexpr int kWgThreads = 128 * (kWgGroups + 1);  // + the producer warpgroup
constexpr int kWgProducerRegs = 24;  // setmaxnreg of the producer warpgroup
constexpr int kWgConsumerRegs = 240;  // and of the consumers
constexpr int kWgMaxStages = 4;
constexpr int kWgMaxChunks = 5;  // 64-wide output chunks of a hidden layer: 320 outputs
constexpr int kWgPassRows = 128;  // outputs per pass of the 8-bit skip layer
constexpr int kWgSmemLimit = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr long long kWgHangClocks = 1ll << 34;
// Bytes of a row of 64 K values (bf16: 128, s8: 64), of an atom of the
// tile's rows, and of a warpgroup's 64 rows of an atom (its A).
template <bool kInt8>
constexpr int kWgRowBytes = kInt8 ? 64 : 128;
template <bool kInt8>
constexpr int kWgAtomBytes = kWgRays * kWgRowBytes<kInt8>;
template <bool kInt8>
constexpr int kWgGroupBytes = 64 * kWgRowBytes<kInt8>;
// K steps of one slice (32 bytes each): 4 of 16 bf16 values, 2 of 32 s8.
template <bool kInt8>
constexpr int kWgKSteps = kInt8 ? 2 : 4;

// Mirrored by ops/_lib.py::NifWg (ctypes); keep the field order.  Filled
// by ops/nif.py::wg_struct from wgmma_plan and wgmma_operands (and by
// probes/quant.py for K8).
struct NifWg {
  int num_layers, embed_dim, log_flag;
  int stages, stage_bytes;  // ring stages and the bytes of one (the largest slice)
  int feat_atoms;  // atoms of the features
  int smem_feat, smem_ring, smem_bar, smem_uv, smem_bytes;  // plan offsets and total
  int chunks[kNifMaxLayers];  // 64-wide output chunks (hidden); 0 = the head's n8 tile
  int in_atoms[kNifMaxLayers];  // K-slices read from the activations
  int f_atoms[kNifMaxLayers];  // K-slices read from the features (layer 0, skip layer)
  int slice_bytes[kNifMaxLayers];  // rows * row bytes
  const void* w[kNifMaxLayers];  // the layer's slices, back to back (bf16 or s8 images)
  const float* b[kNifMaxLayers];  // f32 bias padded with zeros to the layer's rows
  float max_v;
  float mean[3];
  // The 8-bit chains (int8 = 1: s8 slices, s32 accumulators):
  int int8;
  int smem_codes;  // the skip layer's codes of all passes but the last
  int passes[kNifMaxLayers];  // output passes of kWgPassRows (8-bit skip layer), else 1
  float inv_next[kNifMaxLayers];  // requant step of each hidden layer's outputs
  const float* mult[kNifMaxLayers];  // accumulator multipliers, padded with zeros to the rows
  const float* mult_skip;  // the skip layer's feature-dot multipliers, likewise
};

// ---- PTX: mbarriers, bulk copies, proxies and named barriers ----------

PT_HD void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

PT_HD void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

PT_HD void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Whether the phase of the given parity has completed (one bounded try).
PT_HD bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spins until ready() holds; traps after kWgHangClocks instead of hanging.
template <class Ready>
PT_HD void wait_or_trap(Ready ready) {
  long long start = 0;
  while (!ready()) {
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kWgHangClocks) {
      __trap();
    }
  }
}

PT_HD void mbar_wait(uint32_t bar, uint32_t parity) {
  wait_or_trap([=] { return mbar_try(bar, parity); });
}

// `bytes` (a multiple of 16) from global src to shared dst, completing on bar.
PT_HD void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"((uint64_t)src), "r"(bytes), "r"(bar)
      : "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma (async proxy).
PT_HD void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Barrier of one consumer warpgroup (ids 1.., 128 threads; 0 is __syncthreads).
PT_HD void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Barrier of every consumer thread (id kWgGroups + 1): after the role split
// the producer warpgroup has left, so __syncthreads would never complete.
constexpr int kWgConsumers = 128 * kWgGroups;
PT_HD void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kWgGroups + 1), "n"(kWgConsumers) : "memory");
}

// The same barrier, returning whether q holds in any consumer thread.
PT_HD bool consumers_or(bool q) {
  uint32_t any;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.u32 q, %1, 0;\n"
      " bar.red.or.pred p, %2, %3, q;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(any)
      : "r"((uint32_t)q), "n"(kWgGroups + 1), "n"(kWgConsumers)
      : "memory");
  return any != 0;
}

// ---- PTX: wgmma --------------------------------------------------------

// K-major, swizzled to the row's width: start address, leading offset 16 B
// (unused with a swizzle), 8 rows between 8-row groups; layout 1 is the
// 128-byte swizzle (bf16), 2 the 64-byte one (s8).
template <bool kInt8>
PT_HD uint64_t wg_desc(uint32_t saddr) {
  constexpr uint64_t sbo = (8 * kWgRowBytes<kInt8>) >> 4, layout = kInt8 ? 2 : 1;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | (sbo << 32) | (layout << 62);
}

PT_HD void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
PT_HD void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Waits until at most N committed groups of this warp's MMAs are in flight.
template <int N>
PT_HD void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the async MMAs.
template <int N>
PT_HD void wg_fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
PT_HD void wg_fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64 x N] += A[64 x 16] * B[16 x N] in bf16 -> f32, both from shared memory; thread
// register 4i + 2h + e holds (row 16 * warp + g + 8h, column 8i + 2tg + e).
// The accumulators start at zero in registers rather than through scale-d
// 0: read before written, their live ranges would span the layer and tile
// loops, and ptxas spilled every instantiation's set and serialized the
// MMAs.
template <int N>
PT_HD void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
PT_HD void wgmma<8>(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma<192>(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x N] += A[64 x 32] * B[32 x N] in s8 x s8 -> s32, both from shared
// memory, registers laid out as wgmma's f32 ones.  Integer wgmma takes no
// scale or transpose immediates: both operands are K-major, as here.
template <int N>
PT_HD void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db);

template <>
PT_HD void wgmma_s8<8>(int (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma_s8<192>(int (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma_s8<256>(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// The MMA of chain policy Ch on N outputs: s8 (s32 accumulators) or bf16 (f32).
template <class Ch, int N>
PT_HD void wg_mma(typename Ch::Acc (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (Ch::kInt8)
    wgmma_s8<N>(d, da, db);
  else
    wgmma<N>(d, da, db);
}

// Byte offset of (row, k) in a K-major swizzled operand whose atoms hold
// kWgRays rows (activations and features): bf16 128-byte rows, chunk c at
// c ^ (row % 8); s8 64-byte rows, chunk c at c ^ ((row / 2) % 4).
template <bool kInt8>
PT_HD int wg_offset(int row, int k) {
  if constexpr (kInt8)
    return (k >> 6) * kWgAtomBytes<true> + row * 64 + ((((k >> 4) & 3) ^ ((row >> 1) & 3)) << 4) +
           (k & 15);
  else
    return (k >> 6) * kWgAtomBytes<false> + row * 128 + ((((k >> 3) & 7) ^ (row & 7)) << 4) +
           ((k & 7) << 1);
}

// ---- the chain policies ------------------------------------------------

// bf16: y = acc + b; hidden layers ReLU and round to bf16; the head decodes.
struct ChainBf16 {
  static constexpr bool kInt8 = false;
  static constexpr bool kNarrow = false;  // (2-byte chains) K8's epilogue in place of ReLU
  static constexpr int kHeadOutputs = 3;
  using Acc = float;
  PT_HD static float head(const NifWg& net, int l, int o, float acc) {
    const float mean = o == 0 ? net.mean[0] : (o == 1 ? net.mean[1] : net.mean[2]);
    const float z = (acc + net.b[l][o]) * net.max_v + mean;
    return net.log_flag ? expf(z) : z;
  }
};

// int8, K5 (models/quant.quant_layer_t, in its order): y = acc * m
// (+ accf * ms) + b, each product and sum rounded on its own; m, ms and b
// are the output's multiplier, skip multiplier and bias.
struct ChainInt8 {
  static constexpr bool kInt8 = true;
  static constexpr int kHeadOutputs = 3;
  using Acc = int;
  PT_HD static float dense(int acc, float m, float b) {
    const float y = (float)acc * m;
    return y + b;
  }
  PT_HD static float skip(int acc, int accf, float m, float ms, float b) {
    float y = (float)acc * m;
    y = y + (float)accf * ms;
    return y + b;
  }
  // ReLU, then [0, a_l] onto [-128, 127] (the +128 is folded into the next
  // bias): the reference's clip(rint(relu(y) * inv) - 128, -128, 127), in
  // fewer operations.  relu(y) * inv is never below 0 (NaN gives 0), so
  // cvt.rni (round to nearest, ties to even, as rintf; saturating) then a
  // clip at 255 gives rint's integer in [0, 255]; minus 128 is a flip of
  // its byte's top bit.
  PT_HD static uint32_t code(float y, float inv) {
    return (uint32_t)min(__float2int_rn(fmaxf(y, 0.0f) * inv), 255) ^ 0x80u;
  }
  PT_HD static float head(const NifWg& net, int l, int o, int acc) {
    const float mean = o == 0 ? net.mean[0] : (o == 1 ? net.mean[1] : net.mean[2]);
    const float z = dense(acc, net.mult[l][o], net.b[l][o]) * net.max_v + mean;
    return net.log_flag ? expf(z) : z;
  }
};

// Outputs o and o + 1 of a per-output f32 vector (o even).
PT_HD float2 wg_pair(const float* v, int o) {
  return __ldg(reinterpret_cast<const float2*>(v + o));
}

template <bool kInt8>
using NifChain = typename std::conditional<kInt8, ChainInt8, ChainBf16>::type;

// The layer hook of the chains that run none (K2, K3, K4, K8).
struct WgNoHook {
  PT_HD void operator()(int) const {}
};

// ---- the chain ---------------------------------------------------------

// A consumer's place in the ring (the producer's sequence of slices).
struct WgPipe {
  uint32_t full, empty, ring;
  int stage;
  uint32_t phase;
};

// A consumer thread's place: its warpgroup's rows of the activations and
// features (wgmma's A), and its ring position.
struct WgConsumer {
  unsigned char* smem;
  uint32_t a_act, a_feat;
  int wg, t, lane;
  WgPipe pipe;
};

// Waits for the ring's next slice, the s-th of layer l (slices 0..
// in_atoms-1 read this warpgroup's activation rows, the rest its feature
// rows), and gives the A and B descriptors of its first K step.
template <bool kInt8>
PT_HD void wg_slice_begin(const NifWg& net, int l, int s, const WgPipe& p, uint32_t a_act,
                          uint32_t a_feat, uint64_t& da, uint64_t& db) {
  mbar_wait(p.full + 8 * p.stage, p.phase);
  __syncwarp();  // wgmma is .aligned: the warp issues it converged
  const int ia = net.in_atoms[l];
  constexpr int atom = kWgAtomBytes<kInt8>;
  da = wg_desc<kInt8>(s < ia ? a_act + s * atom : a_feat + (s - ia) * atom);
  db = wg_desc<kInt8>(p.ring + p.stage * net.stage_bytes);
}

// Moves to the next stage of the ring.
PT_HD void wg_advance(const NifWg& net, WgPipe& p) {
  if (++p.stage == net.stages) {
    p.stage = 0;
    p.phase ^= 1;
  }
}

// Returns a ring stage to the producer (one arrival per consumer warp).
PT_HD void wg_release(uint32_t empty, int stage, int lane) {
  if (lane == 0) mbar_arrive(empty + 8 * stage);
}

template <int N, class Acc>
PT_HD void wg_zero(Acc (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0;
}

// The 8-bit codes of outputs o, o + 1 of this thread's two rows (h = 0 in
// the low 16 bits), stored into the activations by wg_store_codes.
template <class Codes>
PT_HD uint32_t wg_codes(Codes y) {
  uint32_t w = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) w |= (y(h, 0) | (y(h, 1) << 8)) << (16 * h);
  return w;
}

PT_HD void wg_store_codes(unsigned char* act, int wg, int lane, int o, uint32_t w) {
  const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<uint16_t*>(act + wg_offset<true>(64 * wg + 16 * warp + g + 8 * h, o)) =
        (uint16_t)(w >> (16 * h));
}

// A hidden layer's epilogue for outputs o0.. o0 + N - 1 of this warp's
// rows, written into the activations (in place).  Accumulator register
// 4i + 2h + e is (row 16 * warp + g + 8h, output o0 + 8i + 2tg + e).
// The per-layer pointers are read once, outside the unrolled loop: read
// per output, they held registers enough to spill K3's accumulators.
template <class Ch, int N>
PT_HD void wg_store(const typename Ch::Acc (&acc)[N / 2], const NifWg& net, int l, int o0,
                    unsigned char* act, int wg, int lane) {
  const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, tg = lane & 3;
  const float* const bl = net.b[l];
  const float* const ml = net.mult[l];
  const float inv = net.inv_next[l];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int o = o0 + 8 * i + 2 * tg;
    const float2 bias = wg_pair(bl, o);
    if constexpr (Ch::kInt8) {
      const float2 m = wg_pair(ml, o);
      wg_store_codes(act, wg, lane, o, wg_codes([&](int h, int e) {
                       return Ch::code(Ch::dense(acc[4 * i + 2 * h + e], e ? m.y : m.x,
                                                 e ? bias.y : bias.x),
                                       inv);
                     }));
    } else if constexpr (Ch::kNarrow) {  // the narrow epilogue, its codes as bf16 values
      const float2 m = wg_pair(ml, o);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * wg + 16 * warp + g + 8 * h;
        const uint32_t lo = Ch::act(Ch::dense(acc[4 * i + 2 * h], m.x, bias.x), inv);
        const uint32_t hi = Ch::act(Ch::dense(acc[4 * i + 2 * h + 1], m.y, bias.y), inv);
        *reinterpret_cast<uint32_t*>(act + wg_offset<false>(row, o)) = lo | (hi << 16);
      }
    } else {  // relu(acc + bias) as bf16
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * wg + 16 * warp + g + 8 * h;
        const uint32_t lo = f32_to_bf16(fmaxf(acc[4 * i + 2 * h] + bias.x, 0.0f));
        const uint32_t hi = f32_to_bf16(fmaxf(acc[4 * i + 2 * h + 1] + bias.y, 0.0f));
        *reinterpret_cast<uint32_t*>(act + wg_offset<false>(row, o)) = lo | (hi << 16);
      }
    }
  }
}

// Hidden layer l with NC 64-wide output chunks, as one wgmma of N0 =
// 64 min(NC, 4) outputs per K step, plus one of N1 = 64 for a fifth
// chunk (so A is read from shared memory once or twice per step, not NC
// times); then the epilogue over this warpgroup's rows of the
// activations, in place.  One slice's MMAs stay in flight while the next
// slice's are issued (wait_group 1), and a slice returns to the producer
// when its MMAs have completed.  hook(l) runs while the last slice's MMAs
// are in flight.  (bf16 runs the skip layer here too: its feature slices
// extend the one dot.)
template <class Ch, int NC, class Hook>
PT_HD void wg_hidden(const NifWg& net, int l, WgConsumer& c, const Hook& hook) {
  constexpr bool k8 = Ch::kInt8;
  WgPipe& p = c.pipe;
  unsigned char* const act = c.smem;
  const uint32_t a_act = c.a_act, a_feat = c.a_feat;
  const int wg = c.wg, lane = c.lane;
  constexpr int N0 = 64 * (NC > 4 ? 4 : NC), N1 = 64 * NC - N0;
  typename Ch::Acc acc0[N0 / 2], acc1[N1 ? N1 / 2 : 2];
  wg_zero(acc0);
  wg_zero(acc1);
  const int slices = net.in_atoms[l] + net.f_atoms[l];
  int held = -1;  // the stage whose MMAs may still be in flight
  for (int s = 0; s < slices; ++s) {
    uint64_t da, db;
    wg_slice_begin<k8>(net, l, s, p, a_act, a_feat, da, db);
    wg_fence_regs(acc0);
    wg_fence_regs(acc1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kWgKSteps<k8>; ++ks) {
      wg_mma<Ch, N0>(acc0, da + 2 * ks, db + 2 * ks);
      if constexpr (N1 > 0)
        wg_mma<Ch, N1>(acc1, da + 2 * ks, db + 2 * ks + N0 * kWgRowBytes<k8> / 16);
    }
    wg_commit();
    wg_wait<1>();
    wg_fence_regs(acc0);
    wg_fence_regs(acc1);
    if (held >= 0) wg_release(p.empty, held, lane);
    held = p.stage;
    wg_advance(net, p);
  }
  hook(l);
  wg_wait<0>();
  wg_fence_regs(acc0);
  wg_fence_regs(acc1);
  wg_release(p.empty, held, lane);
  group_sync(wg);  // every warp's MMAs of this layer are done before rows are overwritten
  wg_store<Ch, N0>(acc0, net, l, 0, act, wg, lane);
  if constexpr (N1 > 0) wg_store<Ch, N1>(acc1, net, l, N0, act, wg, lane);
  fence_proxy_async();
  group_sync(wg);
}

// One pass of the 8-bit skip layer over NH outputs: the trunk slices'
// products into acc, the feature slices' into accf (the ring holds the
// pass's half-slices); hook(l) while the last slice's MMAs are in flight.
template <class Ch, int NH, class Hook>
PT_HD void wg_skip_dots(const NifWg& net, int l, WgPipe& p, uint32_t a_act, uint32_t a_feat,
                        int lane, typename Ch::Acc (&acc)[NH / 2],
                        typename Ch::Acc (&accf)[NH / 2], const Hook& hook) {
  wg_zero(acc);
  wg_zero(accf);
  const int ia = net.in_atoms[l], slices = ia + net.f_atoms[l];
  int held = -1;
  // Slice s into d; two loops, not a branch per slice: around a branch
  // ptxas adds a dummy HGMMA to balance the paths' MMA groups.
  auto dots = [&](int s, typename Ch::Acc (&d)[NH / 2]) {
    uint64_t da, db;
    wg_slice_begin<true>(net, l, s, p, a_act, a_feat, da, db);
    wg_fence_regs(acc);
    wg_fence_regs(accf);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kWgKSteps<true>; ++ks) wg_mma<Ch, NH>(d, da + 2 * ks, db + 2 * ks);
    wg_commit();
    wg_wait<1>();
    wg_fence_regs(acc);
    wg_fence_regs(accf);
    if (held >= 0) wg_release(p.empty, held, lane);
    held = p.stage;
    wg_advance(net, p);
  };
  for (int s = 0; s < ia; ++s) dots(s, acc);
  for (int s = ia; s < slices; ++s) dots(s, accf);
  hook(l);
  wg_wait<0>();
  wg_fence_regs(acc);
  wg_fence_regs(accf);
  wg_release(p.empty, held, lane);
}

// The 8-bit skip layer (NC chunks) in passes of kWgPassRows outputs
// (header comment).  The codes of all passes but the last wait in the
// plan's codes area (word w of consumer thread t at [w][t]: each thread
// reads back only its own words) until every warp of the group has
// finished the last pass's reads of the trunk.
template <class Ch, int NC, class Hook>
PT_HD void wg_skip(const NifWg& net, int l, WgConsumer& c, const Hook& hook) {
  WgPipe& p = c.pipe;
  unsigned char* const act = c.smem;
  const uint32_t a_act = c.a_act, a_feat = c.a_feat;
  const int wg = c.wg, lane = c.lane;
  constexpr int kPasses = (NC + 1) / 2, NL = 64 * (NC - 2 * (kPasses - 1));  // last pass
  constexpr int kWords = kWgPassRows / 8;  // code words per thread and full pass
  const int tg = lane & 3;
  const float inv = net.inv_next[l];
  const float* const bl = net.b[l];
  const float* const ml = net.mult[l];
  const float* const msl = net.mult_skip;
  uint32_t* const stash = reinterpret_cast<uint32_t*>(act + net.smem_codes) + threadIdx.x;
  // Word i of the codes of outputs o0.. from a pass's accumulators.
  auto codes = [&](int o0, int i, const auto& acc, const auto& accf) {
    const int o = o0 + 8 * i + 2 * tg;
    const float2 m = wg_pair(ml, o), ms = wg_pair(msl, o), bias = wg_pair(bl, o);
    return wg_codes([&](int h, int e) {
      return Ch::code(Ch::skip(acc[4 * i + 2 * h + e], accf[4 * i + 2 * h + e], e ? m.y : m.x,
                               e ? ms.y : ms.x, e ? bias.y : bias.x),
                      inv);
    });
  };
  for (int pass = 0; pass < kPasses - 1; ++pass) {
    typename Ch::Acc acc[kWgPassRows / 2], accf[kWgPassRows / 2];
    wg_skip_dots<Ch, kWgPassRows>(net, l, p, a_act, a_feat, lane, acc, accf, WgNoHook{});
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      stash[(kWords * pass + i) * kWgConsumers] = codes(kWgPassRows * pass, i, acc, accf);
  }
  typename Ch::Acc acc[NL / 2], accf[NL / 2];
  wg_skip_dots<Ch, NL>(net, l, p, a_act, a_feat, lane, acc, accf, hook);
  group_sync(wg);
  for (int w = 0; w < kWords * (kPasses - 1); ++w)
    wg_store_codes(act, wg, lane, 8 * w + 2 * tg, stash[w * kWgConsumers]);
  constexpr int o_last = kWgPassRows * (kPasses - 1);
#pragma unroll
  for (int i = 0; i < NL / 8; ++i)
    wg_store_codes(act, wg, lane, o_last + 8 * i + 2 * tg, codes(o_last, i, acc, accf));
  fence_proxy_async();
  group_sync(wg);
}

// The skip layer of a narrow 2-byte chain (K8's fp8 codes on the bf16
// tile, Ch::kNarrow), whose trunk and feature dots have two multipliers:
// the trunk slices' products of all NC chunks as wg_hidden's; then, once
// every warp of the group has read the trunk, per 32 outputs the one
// feature slice's products into a set of 16 registers (two full sets would
// not fit; 32 more spilled) and those outputs' epilogue, stored in place.
template <class Ch, int NC, class Hook>
PT_HD void wg_skip_wide(const NifWg& net, int l, WgConsumer& c, const Hook& hook) {
  WgPipe& p = c.pipe;
  const int warp = (threadIdx.x >> 5) & 3, g = c.lane >> 2, tg = c.lane & 3;
  constexpr int N0 = 64 * (NC > 4 ? 4 : NC), N1 = 64 * NC - N0;
  float acc0[N0 / 2], acc1[N1 ? N1 / 2 : 2];
  wg_zero(acc0);
  wg_zero(acc1);
  int held = -1;
  for (int s = 0; s < net.in_atoms[l]; ++s) {
    uint64_t da, db;
    wg_slice_begin<false>(net, l, s, p, c.a_act, c.a_feat, da, db);
    wg_fence_regs(acc0);
    wg_fence_regs(acc1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kWgKSteps<false>; ++ks) {
      wgmma<N0>(acc0, da + 2 * ks, db + 2 * ks);
      if constexpr (N1 > 0) wgmma<N1>(acc1, da + 2 * ks, db + 2 * ks + N0 * 128 / 16);
    }
    wg_commit();
    wg_wait<1>();
    wg_fence_regs(acc0);
    wg_fence_regs(acc1);
    if (held >= 0) wg_release(p.empty, held, c.lane);
    held = p.stage;
    wg_advance(net, p);
  }
  hook(l);
  wg_wait<0>();
  wg_fence_regs(acc0);
  wg_fence_regs(acc1);
  wg_release(p.empty, held, c.lane);
  group_sync(c.wg);  // the trunk is read: the chunks' outputs may overwrite it
  uint64_t da, db;
  wg_slice_begin<false>(net, l, net.in_atoms[l], p, c.a_act, c.a_feat, da, db);
  const float* const bl = net.b[l];
  const float* const ml = net.mult[l];
  const float* const msl = net.mult_skip;
  const float inv = net.inv_next[l];
  // Outputs 32 q.. (their trunk sums t[base..base + 15]): the feature
  // products, the epilogue, the stores.
  auto part = [&](int q, const auto& t, int base) {
    float accf[16];
    wg_zero(accf);
    wg_fence_regs(accf);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kWgKSteps<false>; ++ks)
      wgmma<32>(accf, da + 2 * ks, db + 2 * ks + q * 32 * 128 / 16);
    wg_commit();
    wg_wait<0>();
    wg_fence_regs(accf);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = 32 * q + 8 * i + 2 * tg;
      const float2 m = wg_pair(ml, o), ms = wg_pair(msl, o), bias = wg_pair(bl, o);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 4 * i + 2 * h;  // register of output o in the part's set
        const uint32_t lo = Ch::act(Ch::skip(t[base + r], accf[r], m.x, ms.x, bias.x), inv);
        const uint32_t hi =
            Ch::act(Ch::skip(t[base + r + 1], accf[r + 1], m.y, ms.y, bias.y), inv);
        *reinterpret_cast<uint32_t*>(
            c.smem + wg_offset<false>(64 * c.wg + 16 * warp + g + 8 * h, o)) = lo | (hi << 16);
      }
    }
  };
#pragma unroll
  for (int q = 0; q < N0 / 32; ++q) part(q, acc0, 16 * q);
  if constexpr (N1 > 0) {
    part(N0 / 32, acc1, 0);
    part(N0 / 32 + 1, acc1, 16);
  }
  wg_release(p.empty, p.stage, c.lane);
  wg_advance(net, p);
  fence_proxy_async();
  group_sync(c.wg);
}

// The head (last layer, outputs padded to 8) and its epilogue, stored
// through io for the tile's rays below io.n; hook(l) while the last slice's
// MMAs are in flight.  Accumulator register 2h + e is (row 16 * warp + g +
// 8h, output 2tg + e).
template <class Ch, class Io, class Hook>
PT_HD void wg_head(const NifWg& net, int l, WgPipe& p, uint32_t a_act, uint32_t a_feat, int ray0,
                   int lane, const Io& io, const Hook& hook) {
  constexpr bool k8 = Ch::kInt8;
  typename Ch::Acc acc[4];
  wg_zero(acc);
  const int slices = net.in_atoms[l] + net.f_atoms[l];
  for (int s = 0; s < slices; ++s) {
    uint64_t da, db;
    wg_slice_begin<k8>(net, l, s, p, a_act, a_feat, da, db);
    wg_fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kWgKSteps<k8>; ++ks) wg_mma<Ch, 8>(acc, da + 2 * ks, db + 2 * ks);
    wg_commit();
    if (s == slices - 1) hook(l);
    wg_wait<0>();
    wg_fence_regs(acc);
    wg_release(p.empty, p.stage, lane);
    wg_advance(net, p);
  }
  const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, tg = lane & 3;
  if (2 * tg >= Ch::kHeadOutputs) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ray = ray0 + 16 * warp + g + 8 * h;
    if (ray >= io.n) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = 2 * tg + e;
      if (o < Ch::kHeadOutputs) io.store(o, ray, Ch::head(net, l, o, acc[2 * h + e]));
    }
  }
}

// The stream of slices: one producer thread walks each tile's slices
// (layer by layer; a layer of several passes once per pass, that pass's
// rows of each slice) through the ring.
struct WgProducer {
  uint32_t full, empty, ring;
  int stage;
  uint32_t phase;
  int issued;  // fills issued so far

  // One tile's slices.  wait_free(bar, parity) waits for a stage to be
  // free and returns false to end the stream (then so does chain).
  template <class WaitFree>
  PT_HD bool chain(const NifWg& net, WaitFree wait_free) {
    for (int l = 0; l < net.num_layers; ++l) {
      const int slices = net.in_atoms[l] + net.f_atoms[l], passes = net.passes[l];
      const int slice = net.slice_bytes[l];
      const int step = passes > 1 ? kWgPassRows * kWgRowBytes<true> : slice;  // a pass's rows
      const unsigned char* const src = (const unsigned char*)net.w[l];
      for (int pass = 0; pass < passes; ++pass) {
        const uint32_t bytes = (uint32_t)min(step, slice - pass * step);
        for (int s = 0; s < slices; ++s) {
          if (!wait_free(empty + 8 * stage, phase ^ 1)) return false;
          mbar_expect_tx(full + 8 * stage, bytes);
          bulk_load(ring + stage * net.stage_bytes, src + (size_t)s * slice + (size_t)pass * step,
                    bytes, full + 8 * stage);
          ++issued;
          if (++stage == net.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return true;
  }

  // Waits until the last fills (at most one per stage, perhaps never
  // consumed) have landed, so that no bulk copy outlives the block.
  PT_HD void drain(const NifWg& net) const {
    int st = stage;
    uint32_t ph = phase;
    for (int i = 0; i < issued && i < net.stages; ++i) {
      if (st == 0) {
        st = net.stages;
        ph ^= 1;
      }
      --st;
      mbar_wait(full + 8 * st, ph);
    }
  }
};

// K3's control word (shared memory, written by consumer thread 0, read by
// the producer): no tile to shade yet, stream, or the block is done.
enum WgCtl { kCtlIdle = 0, kCtlGo = 1, kCtlDone = 2 };

// K3's producer: nothing until the consumers first ask for a tile (a block
// whose tiles are all skipped reads no weights), then the slice sequence
// over and over, one tile's slices after another, as far as the ring lets
// it run ahead, until the consumers say they are done; then it drains.
// Every tile walks the same sequence, so the consumers take whole tiles
// from the stream in order, for the tiles they shade.
PT_HD void wg_stream(const NifWg& net, WgProducer& prod, const volatile int* ctl) {
  wait_or_trap([=] {
    if (*ctl != kCtlIdle) return true;
    __nanosleep(256);
    return false;
  });
  if (*ctl == kCtlDone) return;
  auto wait_free = [=](uint32_t bar, uint32_t parity) {
    bool go = true;
    wait_or_trap([&] {
      if (mbar_try(bar, parity)) return true;
      go = *ctl != kCtlDone;
      return !go;
    });
    return go;
  };
  while (prod.chain(net, wait_free)) {
  }
  prod.drain(net);
}

// The block's dynamic shared memory, aligned to the swizzle's 1024 bytes,
// and the ring's barriers in it.
struct WgBlock {
  unsigned char* smem;
  uint32_t s0, full, empty;
};

__device__ __forceinline__ WgBlock wg_block(const NifWg& net) {
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  unsigned char* const smem = wg_smem_raw + ((1024 - (smem_u32(wg_smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_u32(smem);
  return {smem, s0, s0 + net.smem_bar, s0 + net.smem_bar + 8 * kWgMaxStages};
}

// Run by every thread of the block before the role split: the ring's
// barriers and the features' zero columns (from 4E up).  The caller then
// synchronizes the block.
PT_HD void wg_setup(const NifWg& net, const WgBlock& b) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < net.stages; ++s) {
      mbar_init(b.full + 8 * s, 1);
      mbar_init(b.empty + 8 * s, 4 * kWgGroups);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < (net.smem_codes - net.smem_feat) / 16; i += kWgThreads)
    reinterpret_cast<uint4*>(b.smem + net.smem_feat)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
}

// The role split: the producer warpgroup gives its registers back and one
// of its threads runs produce(); there it returns true, and the caller
// returns (the producer's paths never rejoin the consumers').  The
// consumers take the registers and get false.
template <class Produce>
PT_HD bool wg_producer_role(Produce produce) {
  const int warp = threadIdx.x >> 5;
  if (warp >= 4 * kWgGroups) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (warp == 4 * kWgGroups && (threadIdx.x & 31) == 0) produce();
    return true;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
  return false;
}

template <bool kInt8>
PT_HD WgConsumer wg_consumer(const NifWg& net, const WgBlock& b) {
  const int tid = threadIdx.x, wg = tid >> 7;
  return {b.smem, b.s0 + wg * kWgGroupBytes<kInt8>,  // activations at offset 0
          b.s0 + net.smem_feat + wg * kWgGroupBytes<kInt8>, wg, tid & 127, tid & 31,
          WgPipe{b.full, b.empty, b.s0 + net.smem_ring, 0, 0}};
}

// Feature f of row `row` into the feature atoms: bf16, or the s8 code on
// the constant 1/127 grid, clip(rint(f * 127), -127, 127).
template <bool kInt8>
PT_HD void wg_put_feature(unsigned char* feat, int row, int k, float f) {
  if constexpr (kInt8)
    feat[wg_offset<true>(row, k)] =
        (uint8_t)(int8_t)(int)fminf(fmaxf(rintf(f * 127.0f), -127.0f), 127.0f);
  else
    *reinterpret_cast<uint16_t*>(feat + wg_offset<false>(row, k)) = f32_to_bf16(f);
}

// The Fourier features [sin u 2^j | sin v 2^j | cos u 2^j | cos v 2^j] of
// this warpgroup's 64 rows, from su / sv (its rows' u and v).
template <bool kInt8>
PT_HD void wg_encode(const NifWg& net, const WgConsumer& c, const float* su, const float* sv) {
  const int E = net.embed_dim;
  unsigned char* const feat = c.smem + net.smem_feat;
  for (int idx = c.t; idx < 64 * 2 * E; idx += 128) {
    const int r = idx & 63, rest = idx >> 6, axis = rest & 1, j = rest >> 1;
    float s, co;
    fourier(axis ? sv[r] : su[r], j, &s, &co);
    const int row = 64 * c.wg + r;
    wg_put_feature<kInt8>(feat, row, axis * E + j, s);
    wg_put_feature<kInt8>(feat, row, 2 * E + axis * E + j, co);
  }
  fence_proxy_async();
  group_sync(c.wg);
}

// The layers of one tile over the features in place, run by both consumer
// warpgroups; the head stored through io for rays ray0 (this group's
// first row) + 0..63; hook(l) once per layer l (header comment).
template <class Ch, class Io, class Hook = WgNoHook>
PT_HD void wg_layers(const NifWg& net, WgConsumer& c, int ray0, const Io& io,
                     const Hook& hook = {}) {
  for (int l = 0; l < net.num_layers; ++l) {
    const int nc = net.chunks[l];
    if (nc == 0) {
      wg_head<Ch>(net, l, c.pipe, c.a_act, c.a_feat, ray0, c.lane, io, hook);
      continue;
    }
    if constexpr (Ch::kInt8) {  // the skip layer: two dots
      if (net.in_atoms[l] && net.f_atoms[l]) {
        switch (nc) {
          case 1: wg_skip<Ch, 1>(net, l, c, hook); break;
          case 2: wg_skip<Ch, 2>(net, l, c, hook); break;
          case 3: wg_skip<Ch, 3>(net, l, c, hook); break;
          case 4: wg_skip<Ch, 4>(net, l, c, hook); break;
          default: wg_skip<Ch, kWgMaxChunks>(net, l, c, hook); break;
        }
        continue;
      }
    } else if constexpr (Ch::kNarrow) {  // its skip layer: two dots, chunk by chunk
      if (net.in_atoms[l] && net.f_atoms[l]) {
        switch (nc) {
          case 1: wg_skip_wide<Ch, 1>(net, l, c, hook); break;
          case 2: wg_skip_wide<Ch, 2>(net, l, c, hook); break;
          case 3: wg_skip_wide<Ch, 3>(net, l, c, hook); break;
          case 4: wg_skip_wide<Ch, 4>(net, l, c, hook); break;
          default: wg_skip_wide<Ch, kWgMaxChunks>(net, l, c, hook); break;
        }
        continue;
      }
    }
    switch (nc) {
      case 1: wg_hidden<Ch, 1>(net, l, c, hook); break;
      case 2: wg_hidden<Ch, 2>(net, l, c, hook); break;
      case 3: wg_hidden<Ch, 3>(net, l, c, hook); break;
      case 4: wg_hidden<Ch, 4>(net, l, c, hook); break;
      default: wg_hidden<Ch, kWgMaxChunks>(net, l, c, hook); break;
    }
  }
}

// One tile's chain: the encode of this warpgroup's rows (their (u, v) in
// su / sv, already visible to the group), then the layers.
template <class Ch, class Io>
PT_HD void wg_tile(const NifWg& net, WgConsumer& c, const float* su, const float* sv, int ray0,
                   const Io& io) {
  wg_encode<Ch::kInt8>(net, c, su, sv);
  wg_layers<Ch>(net, c, ray0, io);
}

// The measurement stub of a tile (the reference's _stub_nif_layer) in
// this geometry: the encode as in wg_tile, then, with no copies and no
// MMAs, each row's first feature x (its bf16 value or its s8 code) ->
// x * 0 + 1 per layer and the decode of that 1, stored through io as
// wg_head stores.
template <class Ch, class Io>
PT_HD void wg_tile_stub(const NifWg& net, const WgConsumer& c, const float* su, const float* sv,
                        int ray0, const Io& io) {
  wg_encode<Ch::kInt8>(net, c, su, sv);
  if (c.t >= 64) return;
  const unsigned char* const feat = c.smem + net.smem_feat;
  const int row = 64 * c.wg + c.t;
  float x;
  if constexpr (Ch::kInt8)
    x = (float)(int8_t)feat[wg_offset<true>(row, 0)];
  else
    x = __uint_as_float((uint32_t)*reinterpret_cast<const uint16_t*>(
                            feat + wg_offset<false>(row, 0))
                        << 16);
  for (int l = 0; l < net.num_layers; ++l) x = x * 0.0f + 1.0f;
#pragma unroll
  for (int o = 0; o < 3; ++o) {  // decode at f32: y * max + mean, exp if log
    const float z = x * net.max_v + net.mean[o];
    io.store(o, ray0 + c.t, net.log_flag ? expf(z) : z);
  }
}

// The block's roles over `tiles` tiles, the block persistent over tiles
// blockIdx.x + i * gridDim.x: the producer streams each tile's slices
// `passes` times over, and every consumer thread runs tile(c, t) for each
// tile t, which takes `passes` passes of the chain (K2, K4 and K8 one,
// through nif_wg_tiles; K6 one and K7 one per loop iteration, with their
// own ends).  Launch with kWgThreads threads and net.smem_bytes of dynamic
// shared memory.
template <bool kInt8, class Tile>
__device__ __forceinline__ void wg_tiles(const NifWg& net, int tiles, Tile tile,
                                         int passes = 1) {
  const WgBlock b = wg_block(net);
  wg_setup(net, b);
  __syncthreads();
  if (wg_producer_role([&] {
        WgProducer prod{b.full, b.empty, b.s0 + net.smem_ring, 0, 0, 0};
        for (int t = blockIdx.x; t < tiles; t += gridDim.x)
          for (int i = 0; i < passes; ++i)
            prod.chain(net, [](uint32_t bar, uint32_t parity) {
              mbar_wait(bar, parity);
              return true;
            });
      }))
    return;

  WgConsumer c = wg_consumer<kInt8>(net, b);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) tile(c, t);
}

// K2, K4 and K8's body: io.n rays.  An Io with kFeatures = false gives each
// ray's (u, v) (io.uv) for the encode; one with kFeatures = true puts
// io.rows precomputed feature rows (io.put).  io.store(o, ray, y) takes
// each head output.
template <class Ch, class Io>
__device__ __forceinline__ void nif_wg_tiles(const NifWg& net, const Io& io) {
  wg_tiles<Ch::kInt8>(net, (io.n + kWgRays - 1) / kWgRays, [&](WgConsumer& c, int tile) {
    const int ray0 = tile * kWgRays + 64 * c.wg;
    if constexpr (Io::kFeatures) {  // the group's rows of the features (the encode's place)
      unsigned char* const feat = c.smem + net.smem_feat;
      for (int idx = c.t; idx < 64 * io.rows; idx += 128) {
        const int r = idx & 63, k = idx >> 6;
        io.template put<Ch>(feat, 64 * c.wg + r, k, ray0 + r);
      }
      fence_proxy_async();
      group_sync(c.wg);
      wg_layers<Ch>(net, c, ray0, io);
    } else {
      float* const su = (float*)(c.smem + net.smem_uv) + 64 * c.wg;
      float* const sv = su + kWgRays;
      if (c.t < 64) {
        float u = 0.0f, v = 0.0f;
        if (ray0 + c.t < io.n) io.uv(ray0 + c.t, &u, &v);
        su[c.t] = u;
        sv[c.t] = v;
      }
      group_sync(c.wg);
      wg_tile<Ch>(net, c, su, sv, ray0, io);
    }
  });
}

// K2's ends: equirect (u, v) of the escape direction; bgr -> rgb times the
// escape weights.
struct WgShadeIo {
  static constexpr bool kFeatures = false;
  const float* escd;
  const float* escw;
  float azimuth;
  int n;
  float* out;
  PT_HD void uv(int p, float* u, float* v) const {
    equirect_uv(escd[p], escd[n + p], escd[2 * n + p], azimuth, u, v);
  }
  PT_HD void store(int o, int p, float y) const {
    const int c = 2 - o;
    out[c * n + p] = escw[c * n + p] * y;
  }
};

// K4's ends: given (u, v); (3, n) network order.
struct WgApplyIo {
  static constexpr bool kFeatures = false;
  const float* u;
  const float* v;
  int n;
  float* out;
  PT_HD void uv(int p, float* pu, float* pv) const {
    *pu = u[p];
    *pv = v[p];
  }
  PT_HD void store(int o, int p, float y) const { out[o * n + p] = y; }
};

// Whether the kernels can take net's plan and operands.
inline bool wg_valid(const NifWg& net) {
  if (net.stages < 2 || net.stages > kWgMaxStages || net.smem_bytes > kWgSmemLimit ||
      net.num_layers < 1 || net.num_layers > kNifMaxLayers)
    return false;
  for (int l = 0; l < net.num_layers; ++l)
    if (((uintptr_t)net.w[l] & 15) || net.slice_bytes[l] > net.stage_bytes ||
        net.chunks[l] < 0 || net.chunks[l] > kWgMaxChunks ||
        net.passes[l] != (net.int8 && net.in_atoms[l] && net.f_atoms[l] && net.chunks[l]
                              ? (net.chunks[l] + 1) / 2
                              : 1) ||
        (net.int8 && net.mult[l] == nullptr))
      return false;
  return !net.int8 || net.mult_skip != nullptr;
}

// Validates the plan, sets the dynamic shared memory and launches one
// persistent block per SM (or as many as fit), at most one per tile.
template <typename Kernel, typename... Args>
int launch_wg(Kernel kernel, const NifWg& net, int n, void* stream, Args... args) {
  if (!wg_valid(net)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         net.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kWgRays - 1) / kWgRays;
  if (tiles == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWgThreads,
                                                           net.smem_bytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  kernel<<<blocks, kWgThreads, net.smem_bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace pt
