// The NIF chains on Hopper's warpgroup MMA, for K2 and K4 (nif.cu), K3
// (megastep.cuh) and the probes K6 and K7 (probes.cu) and K8 (quant_probe.cu):
// encode -> layers -> decode for tiles of rays, the weights streamed
// through shared memory by bulk copies.  The chains share the ring and the
// slice sequence; a chain policy (ChainBf16, ChainInt8, ChainTf32, K8's
// ChainK8 and ChainK8Wide) gives the operand width kOp (1: the s8 tile and
// s8 wgmma; 2: bf16; 4: f32 on tf32 wgmma), which sets the tile (128 rays,
// 64 for tf32), and the epilogue (kInt8's; kNarrow: K8's on the bf16 tile):
//  * bf16 (ChainBf16): what models/nif.nif_apply computes - encode_bf16's
//    direct sincosf angles, bf16 weights and activations with f32
//    accumulation, f32 bias, ReLU and a round to bf16 between layers, the
//    skip layer's concat(trunk, feats) as the tail of its K dimension, the
//    f32 decode y * max + mean (exp when log-tone-mapped) - in another order
//    of f32 sums;
//  * tf32 (ChainTf32; the reference's chain at --partials-type float,
//    models/nif.nif_apply on f32 weights): f32 features and activations,
//    f32 weights, f32 sums, bias and ReLU with no rounding to bf16 between
//    layers, the skip concat and the decode as bf16's, on TF32 wgmma
//    (m64nNk8, 495 TFLOP/s dense), the card's only tensor-core route for
//    f32 operands, in 3xTF32: each operand x is split into hi = tf32(x)
//    and lo = tf32(x - hi) (cvt.rna), and each product is hi.hi + lo.hi +
//    hi.lo.  One pass (hi.hi) misses the reference's f32 budget on the
//    canonical asset (max 4.0e-2 of 1.5e-2 by a CPU emulation; PERF.md):
//    the log decode exponentiates the features' and activations' rounding.
//    A is read from the f32 activations and features by generic loads and
//    split in registers (wgmma with A in registers: wg_tf32_dots); the
//    weights' hi images are the layer's slices and their lo images (none
//    where every weight is a tf32 value, as for the f16-trained assets)
//    follow each hi slice in the stream.  A 4-byte operand fills a
//    128-byte row with 32 K values, so a layer has twice the slices of
//    bf16.  At 128 rays the f32 activations (163,840 B for 320 outputs)
//    and features (32,768 B) and two ring stages (81,920 B) would need
//    278,528 B, past kWgSmemLimit; so the tile is 64 rays, the activations
//    81,920 B and the features 16,384 B, room for three stages of 40,960 B
//    (320 rows x 32 inputs).  Both consumer warpgroups work on the same 64
//    rows (wgmma's M): the first takes ceil(NC / 2) of a layer's NC output
//    chunks (at most 3, 96 accumulators a thread), the second the rest,
//    and a barrier over both (consumers_sync) stands between the layer's
//    products and its in-place stores; both run the head's few MMAs, the
//    first stores;
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
// the tile (wgmma's M; tf32: both on the tile's 64), and a producer
// warpgroup one thread of which walks the same slice sequence (layer by
// layer, tile after tile: in K2 and K4 the block is persistent over tiles
// blockIdx.x + i * gridDim.x) and keeps the ring's `stages` slices
// filled: full[s] completes on the bulk copy's bytes,
// empty[s] on one arrival per consumer warp once its MMAs on the slice have
// completed.  A consumer issues a slice's MMAs while the previous slice's
// are still in flight (wgmma.wait_group 1), so it holds two stages.
// Per K step (16 bf16, 8 tf32 or 32 8-bit values: 32 bytes) a hidden layer
// of NC 64-wide output chunks is one wgmma of N = 64 min(NC, 4) plus, for
// a fifth chunk, one of N = 64 (tf32: each group's share, N = 64 NC_group);
// the head is one of N = 8 (outputs padded to 8).  A sixth chunk (hidden
// widths 321-384) does not fit beside the others in registers: such a
// layer runs in passes (wg_hidden_passes, below).
//
// Layouts: every wgmma operand is K-major; a row holds 64 K values - 128
// bytes of bf16 under the 128-byte swizzle, 64 bytes of s8 under the
// 64-byte swizzle - or 32 f32 values in 128 bytes (tf32), and an "atom" is
// that row for a set of rows.  16-byte chunk c of row r sits at chunk c ^
// (r % 8) (128-byte) or c ^ ((r / 2) % 4) (64-byte) of the row
// (wg_offset), 8-row groups 8 rows apart (the
// descriptor's stride offset: 1024 or 512 bytes), and the K steps inside
// an atom advance the descriptor by 32 bytes.
//   * weights: a slice is one layer's rows (outputs, padded to 64 for a
//     hidden layer, to 8 for the head) x a row's K values (64; tf32 32), packed on the host into
//     exactly this image (ops/nif.py::wgmma_operands), so one copy of
//     rows * row bytes fills a stage.  Input columns past the layer's
//     fan-in are zero;
//   * activations: [atom][128 rays][row], updated in place: a warpgroup
//     reads only its own 64 rows as A, and it overwrites them with the
//     layer's outputs after its last wgmma of the layer has completed,
//     holding all of a layer's outputs (up to 320) as 160 accumulators per
//     thread (a wider layer: its passes' outputs, below);
//   * features: their own atoms, written by the encode, the columns from
//     4E up zeroed once per block.  Layer 0 reads them as its input, the
//     skip layer as the slices after its trunk slices.
// Each layer's K is its fan-in rounded up to a row (64; tf32 32): the padded weight columns
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
// Hidden widths 321-384 (six chunks; the 1- and 2-byte chains): 192
// accumulators a thread would leave too few of kWgConsumerRegs for the
// epilogue and, in K3, the rays' state.  So the layer runs in two passes of
// kWgPassChunks = 3 chunks (wg_hidden_passes), each one wgmma of N = 192 a
// K step over all of the layer's slices, the producer streaming each
// slice's rows of that pass (NifWg::passes; the ring's stages hold a
// pass's rows, 24,576 B bf16), so no weight byte is read twice and at most
// 96 accumulators are live.  Every pass reads the layer's input rows, so
// the first pass's outputs cannot overwrite them: they wait in registers
// as the words the epilogue stores - 48 bf16 pairs in registers, 144 with
// the second pass's accumulators against the 160 of a five-chunk layer; the
// int8 chain's s8 codes, both passes', in the plan's codes area (49,152 B
// for 128 rays), as its six-chunk skip layer's three passes - and all are
// stored once the group has finished the last pass.  The tf32 chain needs
// no passes: its groups split the six chunks, three each.
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

constexpr int kWgRays = 128;  // rays per tile (block) of the 2- and 1-byte chains
constexpr int kWgGroups = 2;  // consumer warpgroups
constexpr int kWgThreads = 128 * (kWgGroups + 1);  // + the producer warpgroup
constexpr int kWgProducerRegs = 24;  // setmaxnreg of the producer warpgroup
constexpr int kWgConsumerRegs = 240;  // and of the consumers
constexpr int kWgMaxStages = 4;
constexpr int kWgMaxChunks = 6;  // 64-wide output chunks of a hidden layer: 384 outputs
constexpr int kWgRegChunks = 5;  // chunks a layer holds in registers at once (160 accumulators)
constexpr int kWgPassChunks = 3;  // chunks per pass of a wider layer (wg_hidden_passes)
constexpr int kWgPassRows = 128;  // outputs per pass of the 8-bit skip layer
constexpr int kWgSmemLimit = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr long long kWgHangClocks = 1ll << 34;
// A chain's operands are kOp-byte values: 1 the s8 codes (ChainInt8), 2
// bf16 (ChainBf16, K8's ChainK8Wide), 4 f32 read as tf32 (ChainTf32).  By
// the chain policy's kOp: the bytes of a K-major row (64 under the 64-byte
// swizzle for s8, else 128 under the 128-byte one) and its K values (64,
// 64, 32); whether the two consumer warpgroups split each layer's output
// chunks over one 64-ray tile (the 4-byte chain) instead of owning 64 rows
// each of a 128-ray tile; the tile's rays; the bytes of an atom (a row for
// each of the tile's rays); the K steps of one slice (32 bytes each: 4 of
// 16 bf16 or 8 tf32 values, 2 of 32 s8).
template <int kOp>
constexpr int kWgRowBytes = kOp == 1 ? 64 : 128;
template <int kOp>
constexpr int kWgRowK = kWgRowBytes<kOp> / kOp;
template <int kOp>
constexpr bool kWgSplit = kOp == 4;
template <int kOp>
constexpr int kWgTileRays = kWgSplit<kOp> ? 64 : kWgRays;
template <int kOp>
constexpr int kWgAtomBytes = kWgTileRays<kOp> * kWgRowBytes<kOp>;
template <int kOp>
constexpr int kWgKSteps = kWgRowBytes<kOp> / 32;

// The first of warpgroup wg's rows in the tile (wgmma's A; its rays).
template <int kOp>
PT_HD int wg_row0(int wg) {
  return kWgSplit<kOp> ? 0 : 64 * wg;
}

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
  int passes[kNifMaxLayers];  // output passes: of kWgPassRows (8-bit skip layer) or
                             // kWgPassChunks chunks (a wider layer), else 1
  float inv_next[kNifMaxLayers];  // requant step of each hidden layer's outputs
  const float* mult[kNifMaxLayers];  // accumulator multipliers, padded with zeros to the rows
  const float* mult_skip;  // the skip layer's feature-dot multipliers, likewise
  // The f32 chain (tf32 = 1: 4-byte slices, the 64-ray tile, 3xTF32): per
  // layer the lo images of its slices, nullptr where the weights are tf32
  // values (w holds their hi images).
  int tf32;
  const void* w_lo[kNifMaxLayers];
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
// 128-byte swizzle (bf16, tf32), 2 the 64-byte one (s8).
template <int kOp>
PT_HD uint64_t wg_desc(uint32_t saddr) {
  constexpr uint64_t sbo = (8 * kWgRowBytes<kOp>) >> 4, layout = kOp == 1 ? 2 : 1;
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

template <int N>
PT_HD void wg_fence_regs(uint32_t (&r)[N]) {
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

// d[64 x N] += A[64 x 8] * B[8 x N] in tf32 -> f32, A from registers
// (this thread's four values: wg_tf32_a), B from shared memory (K-major,
// the 128-byte swizzle; tf32 takes no transpose immediates), the
// accumulators laid out as the bf16 ones.  The tf32 chain's widths: a
// warpgroup's share of a hidden layer (1-3 chunks of 64) and the head.
template <int N>
PT_HD void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
PT_HD void wgmma_tf32<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
PT_HD void wgmma_tf32<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// The MMA of chain policy Ch on N outputs, both operands in shared memory:
// s8 (s32 accumulators) or bf16 (f32).  (The tf32 chain reads A from
// registers: wg_tf32_dots.)
template <class Ch, int N>
PT_HD void wg_mma(typename Ch::Acc (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (Ch::kOp == 1)
    wgmma_s8<N>(d, da, db);
  else
    wgmma<N>(d, da, db);
}

// Byte offset of (row, k) in a K-major swizzled operand whose atoms hold
// the tile's rows (activations and features): bf16 and tf32 128-byte rows
// (64 or 32 K values), chunk c at c ^ (row % 8); s8 64-byte rows, chunk c
// at c ^ ((row / 2) % 4).
template <int kOp>
PT_HD int wg_offset(int row, int k) {
  if constexpr (kOp == 1)
    return (k >> 6) * kWgAtomBytes<1> + row * 64 + ((((k >> 4) & 3) ^ ((row >> 1) & 3)) << 4) +
           (k & 15);
  else if constexpr (kOp == 4)
    return (k >> 5) * kWgAtomBytes<4> + row * 128 + ((((k >> 2) & 7) ^ (row & 7)) << 4) +
           ((k & 3) << 2);
  else
    return (k >> 6) * kWgAtomBytes<2> + row * 128 + ((((k >> 3) & 7) ^ (row & 7)) << 4) +
           ((k & 7) << 1);
}

// f32 -> tf32 rounded to nearest, ties away from zero (the low 13 bits
// zero): the tf32 chain's split of each operand x into hi = tf32(x) and
// lo = tf32(x - hi) (wg_tf32_a; ops/nif.py::tf32_split splits the weights
// the same way on the host), so the hardware never drops an operand's bits.
PT_HD float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The barrier between the phases of a tile: over the warpgroup's 128
// threads, or over both consumer warpgroups where they share the tile's rows.
template <int kOp>
PT_HD void wg_sync(int wg) {
  if constexpr (kWgSplit<kOp>)
    consumers_sync();
  else
    group_sync(wg);
}

// ---- the chain policies ------------------------------------------------

// bf16: y = acc + b; hidden layers ReLU and round to bf16; the head decodes.
struct ChainBf16 {
  static constexpr int kOp = 2;
  static constexpr bool kInt8 = false;
  static constexpr bool kNarrow = false;  // (2-byte chains) K8's epilogue in place of ReLU
  static constexpr int kHeadOutputs = 3;
  static constexpr int kMaxChunks = kWgMaxChunks;  // widest hidden layer it is built for
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
  static constexpr int kOp = 1;
  static constexpr bool kInt8 = true;
  static constexpr int kHeadOutputs = 3;
  static constexpr int kMaxChunks = kWgMaxChunks;
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

// f32 (the reference's --partials-type float): the bf16 chain's arithmetic
// with f32 operands read as tf32 - f32 features, weights and activations
// (each rounded to tf32 as it is written to shared memory), f32 sums, bias
// and ReLU with no rounding to bf16 between layers, the f32 decode - on
// the 64-ray tile whose rows both consumer warpgroups share.
struct ChainTf32 : ChainBf16 {
  static constexpr int kOp = 4;
};

// The chain of a model's operand width (NifWg: int8 1, tf32 4, else 2).
template <int kOp>
using NifChain = typename std::conditional<
    kOp == 1, ChainInt8, typename std::conditional<kOp == 4, ChainTf32, ChainBf16>::type>::type;

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
template <int kOp>
PT_HD void wg_slice_begin(const NifWg& net, int l, int s, const WgPipe& p, uint32_t a_act,
                          uint32_t a_feat, uint64_t& da, uint64_t& db) {
  mbar_wait(p.full + 8 * p.stage, p.phase);
  __syncwarp();  // wgmma is .aligned: the warp issues it converged
  const int ia = net.in_atoms[l];
  constexpr int atom = kWgAtomBytes<kOp>;
  da = wg_desc<kOp>(s < ia ? a_act + s * atom : a_feat + (s - ia) * atom);
  db = wg_desc<kOp>(p.ring + p.stage * net.stage_bytes);
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
    *reinterpret_cast<uint16_t*>(act + wg_offset<1>(64 * wg + 16 * warp + g + 8 * h, o)) =
        (uint16_t)(w >> (16 * h));
}

// A hidden layer's epilogue for outputs o0.. o0 + N - 1 of this warp's
// rows, written into the activations (in place).  Accumulator register
// 4i + 2h + e is (row wg_row0 + 16 * warp + g + 8h, output o0 + 8i + 2tg + e).
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
        *reinterpret_cast<uint32_t*>(act + wg_offset<2>(row, o)) = lo | (hi << 16);
      }
    } else if constexpr (Ch::kOp == 4) {  // relu(acc + bias) in f32, unrounded
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g + 8 * h;
        *reinterpret_cast<float2*>(act + wg_offset<4>(row, o)) =
            make_float2(fmaxf(acc[4 * i + 2 * h] + bias.x, 0.0f),
                        fmaxf(acc[4 * i + 2 * h + 1] + bias.y, 0.0f));
      }
    } else {  // relu(acc + bias) as bf16
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * wg + 16 * warp + g + 8 * h;
        const uint32_t lo = f32_to_bf16(fmaxf(acc[4 * i + 2 * h] + bias.x, 0.0f));
        const uint32_t hi = f32_to_bf16(fmaxf(acc[4 * i + 2 * h + 1] + bias.y, 0.0f));
        *reinterpret_cast<uint32_t*>(act + wg_offset<2>(row, o)) = lo | (hi << 16);
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
  constexpr int kOp = Ch::kOp;
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
    wg_slice_begin<kOp>(net, l, s, p, a_act, a_feat, da, db);
    wg_fence_regs(acc0);
    wg_fence_regs(acc1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kWgKSteps<kOp>; ++ks) {
      wg_mma<Ch, N0>(acc0, da + 2 * ks, db + 2 * ks);
      if constexpr (N1 > 0)
        wg_mma<Ch, N1>(acc1, da + 2 * ks, db + 2 * ks + N0 * kWgRowBytes<kOp> / 16);
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

// One pass's products over layer l's slices, N outputs a K step, into acc:
// wg_hidden's slice loop for a layer in passes, whose ring stages hold only
// the pass's rows of each slice (so B starts at the stage); hook(l) while
// the last slice's MMAs are in flight.
template <class Ch, int N, class Hook>
PT_HD void wg_pass_dots(const NifWg& net, int l, WgConsumer& c, typename Ch::Acc (&acc)[N / 2],
                        const Hook& hook) {
  constexpr int kOp = Ch::kOp;
  WgPipe& p = c.pipe;
  wg_zero(acc);
  const int slices = net.in_atoms[l] + net.f_atoms[l];
  int held = -1;
  for (int s = 0; s < slices; ++s) {
    uint64_t da, db;
    wg_slice_begin<kOp>(net, l, s, p, c.a_act, c.a_feat, da, db);
    wg_fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kWgKSteps<kOp>; ++ks) wg_mma<Ch, N>(acc, da + 2 * ks, db + 2 * ks);
    wg_commit();
    wg_wait<1>();
    wg_fence_regs(acc);
    if (held >= 0) wg_release(p.empty, held, c.lane);
    held = p.stage;
    wg_advance(net, p);
  }
  hook(l);
  wg_wait<0>();
  wg_fence_regs(acc);
  wg_release(p.empty, held, c.lane);
}

// The 32-bit words wg_store writes per 8 outputs: a bf16 pair for each of
// the thread's two rows, or one word of s8 codes for both.
template <class Ch>
constexpr int kWgWords = Ch::kInt8 ? 1 : 2;

// wg_store's epilogue for outputs o0.. of acc, as words (bf16: word 2i + h
// is row h's pair of outputs o0 + 8i + 2tg; int8: word i, wg_codes').
template <class Ch, int N>
PT_HD void wg_words(const typename Ch::Acc (&acc)[N / 2], const NifWg& net, int l, int o0,
                    int lane, uint32_t (&w)[N / 8 * kWgWords<Ch>]) {
  const int tg = lane & 3;
  const float* const bl = net.b[l];
  const float* const ml = net.mult[l];
  const float inv = net.inv_next[l];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int o = o0 + 8 * i + 2 * tg;
    const float2 bias = wg_pair(bl, o);
    if constexpr (Ch::kInt8) {
      const float2 m = wg_pair(ml, o);
      w[i] = wg_codes([&](int h, int e) {
        return Ch::code(Ch::dense(acc[4 * i + 2 * h + e], e ? m.y : m.x, e ? bias.y : bias.x),
                        inv);
      });
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t lo = f32_to_bf16(fmaxf(acc[4 * i + 2 * h] + bias.x, 0.0f));
        const uint32_t hi = f32_to_bf16(fmaxf(acc[4 * i + 2 * h + 1] + bias.y, 0.0f));
        w[2 * i + h] = lo | (hi << 16);
      }
    }
  }
}

// Stores wg_words' words for outputs o0.. into this thread's rows.
template <class Ch, int N>
PT_HD void wg_put_words(const uint32_t (&w)[N / 8 * kWgWords<Ch>], int o0, unsigned char* act,
                        int wg, int lane) {
  const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int o = o0 + 8 * i + 2 * tg;
    if constexpr (Ch::kInt8) {
      wg_store_codes(act, wg, lane, o, w[i]);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(act + wg_offset<2>(64 * wg + 16 * warp + g + 8 * h, o)) =
            w[2 * i + h];
    }
  }
}

// A hidden layer of NC > kWgRegChunks chunks (bf16 and int8; the header
// comment says why): the first kWgPassChunks chunks' products and epilogue,
// kept as words, then the rest's, then both stored in place once every warp
// of the group has read the layer's input rows.  bf16 keeps the first
// pass's words in registers; int8 puts every pass's codes in the plan's
// codes area (word w of consumer thread t at [w][t], as wg_skip's: held in
// registers beside the s32 accumulators and K3's ray state, they spilled).
// hook(l) runs in the last pass.
template <class Ch, int NC, class Hook>
PT_HD void wg_hidden_passes(const NifWg& net, int l, WgConsumer& c, const Hook& hook) {
  constexpr int N0 = 64 * kWgPassChunks, N1 = 64 * NC - N0, kKept = N0 / 8 * kWgWords<Ch>;
  static_assert(N1 > 0 && N1 <= N0, "two passes");
  uint32_t* const stash = reinterpret_cast<uint32_t*>(c.smem + net.smem_codes) + threadIdx.x;
  uint32_t kept[Ch::kInt8 ? 1 : kKept];
  {
    typename Ch::Acc acc[N0 / 2];
    wg_pass_dots<Ch, N0>(net, l, c, acc, WgNoHook{});
    if constexpr (Ch::kInt8) {
      uint32_t w[kKept];
      wg_words<Ch, N0>(acc, net, l, 0, c.lane, w);
#pragma unroll
      for (int i = 0; i < kKept; ++i) stash[i * kWgConsumers] = w[i];
    } else {
      wg_words<Ch, N0>(acc, net, l, 0, c.lane, kept);
    }
  }
  constexpr int kLast = N1 / 8 * kWgWords<Ch>;
  uint32_t last[kLast];
  {
    typename Ch::Acc acc[N1 / 2];
    wg_pass_dots<Ch, N1>(net, l, c, acc, hook);
    wg_words<Ch, N1>(acc, net, l, N0, c.lane, last);
  }
  if constexpr (Ch::kInt8) {
#pragma unroll
    for (int i = 0; i < kLast; ++i) stash[(kKept + i) * kWgConsumers] = last[i];
  }
  group_sync(c.wg);  // every warp's MMAs of this layer are done before rows are overwritten
  if constexpr (Ch::kInt8) {  // word i: outputs 8i + 2tg, 8i + 2tg + 1 of both rows
    const int tg = c.lane & 3;
    for (int i = 0; i < kKept + kLast; ++i)
      wg_store_codes(c.smem, c.wg, c.lane, 8 * i + 2 * tg, stash[i * kWgConsumers]);
  } else {
    wg_put_words<Ch, N0>(kept, 0, c.smem, c.wg, c.lane);
    wg_put_words<Ch, N1>(last, N0, c.smem, c.wg, c.lane);
  }
  fence_proxy_async();
  group_sync(c.wg);
}

// The tf32 chain's A operand for K step ks of one atom of the f32
// activations or features (64 rows x 32 K values): this thread's four
// values, as wgmma's m64nNk8 tf32 fragment holds them (value i at row
// 16 * warp + g + 8 (i % 2), K 8 ks + tg + 4 (i / 2)), each split into hi
// = tf32(a) and lo = tf32(a - hi).
PT_HD void wg_tf32_a(const unsigned char* atom, int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = *reinterpret_cast<const float*>(
        atom + wg_offset<4>(16 * warp + g + 8 * (i & 1), 8 * ks + tg + 4 * (i >> 1)));
    const float h = tf32_round(a);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(tf32_round(a - h));
  }
}

// Layer l's products for N outputs from weight row r0 into acc, in 3xTF32:
// per K-slice the hi slice's products with A's hi and lo parts, then, where
// the layer's weights have a lo part (net.w_lo[l]; none for weights that are
// tf32 values, as the f16-trained assets' are), the lo slice's with A's hi
// part - hi.hi + lo.hi + hi.lo, f32 sums.  A is read from the f32
// activations (slices 0.. in_atoms - 1) and features by generic loads and
// held in registers until the slice's MMAs complete (wait_group 0).  N = 0
// (a group with no chunk of the layer) takes each slice and returns it.
template <int N, int NA>
PT_HD void wg_tf32_dots(const NifWg& net, int l, WgConsumer& c, int r0, float (&acc)[NA]) {
  static_assert(N == 0 || NA == N / 2, "one accumulator pair per thread and 8 outputs");
  WgPipe& p = c.pipe;
  const int ia = net.in_atoms[l], slices = ia + net.f_atoms[l];
  const int halves = net.w_lo[l] ? 2 : 1;
  const uint64_t b0 = (uint64_t)(r0 * kWgRowBytes<4> / 16);
  for (int s = 0; s < slices; ++s) {
    const unsigned char* const atom =
        c.smem + (s < ia ? s * kWgAtomBytes<4> : net.smem_feat + (s - ia) * kWgAtomBytes<4>);
    uint32_t hi[kWgKSteps<4>][4], lo[kWgKSteps<4>][4];
    for (int half = 0; half < halves; ++half) {
      uint64_t da, db;
      wg_slice_begin<4>(net, l, s, p, c.a_act, c.a_feat, da, db);
      if constexpr (N > 0) {
        if (half == 0) {
#pragma unroll
          for (int ks = 0; ks < kWgKSteps<4>; ++ks) wg_tf32_a(atom, ks, hi[ks], lo[ks]);
        }
        wg_fence_regs(acc);
        wg_fence();
        if (half == 0) {  // the hi slice: A's hi and lo parts
#pragma unroll
          for (int ks = 0; ks < kWgKSteps<4>; ++ks) {
            wgmma_tf32<N>(acc, hi[ks], db + b0 + 2 * ks);
            wgmma_tf32<N>(acc, lo[ks], db + b0 + 2 * ks);
          }
        } else {  // the lo slice: A's hi part
#pragma unroll
          for (int ks = 0; ks < kWgKSteps<4>; ++ks) wgmma_tf32<N>(acc, hi[ks], db + b0 + 2 * ks);
        }
        wg_commit();
        wg_wait<0>();
        wg_fence_regs(acc);
#pragma unroll
        for (int ks = 0; ks < kWgKSteps<4>; ++ks) {
          wg_fence_regs(hi[ks]);
          wg_fence_regs(lo[ks]);
        }
      }
      wg_release(p.empty, p.stage, c.lane);
      wg_advance(net, p);
    }
  }
}

// A hidden layer of the tf32 chain: this group's NW chunks from chunk c0
// (the groups split the layer's chunks over the tile's 64 rows), then,
// once both groups' products are done, the epilogue in place.
template <class Ch, int NW, class Hook>
PT_HD void wg_hidden_tf32(const NifWg& net, int l, WgConsumer& c, const Hook& hook, int c0) {
  constexpr int N = 64 * NW;
  float acc[N ? N / 2 : 2];
  wg_zero(acc);
  wg_tf32_dots<N>(net, l, c, 64 * c0, acc);
  hook(l);
  consumers_sync();  // both groups have read the layer's input rows
  if constexpr (NW > 0) wg_store<Ch, N>(acc, net, l, 64 * c0, c.smem, c.wg, c.lane);
  consumers_sync();
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
    wg_slice_begin<1>(net, l, s, p, a_act, a_feat, da, db);
    wg_fence_regs(acc);
    wg_fence_regs(accf);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kWgKSteps<1>; ++ks) wg_mma<Ch, NH>(d, da + 2 * ks, db + 2 * ks);
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
// finished the last pass's reads of the trunk; with six chunks the last
// pass is a full one and its codes go there too (computed after the
// barrier, beside the restored words, they spilled).
template <class Ch, int NC, class Hook>
PT_HD void wg_skip(const NifWg& net, int l, WgConsumer& c, const Hook& hook) {
  WgPipe& p = c.pipe;
  unsigned char* const act = c.smem;
  const uint32_t a_act = c.a_act, a_feat = c.a_feat;
  const int wg = c.wg, lane = c.lane;
  constexpr int kPasses = (NC + 1) / 2, NL = 64 * (NC - 2 * (kPasses - 1));  // last pass
  constexpr int kWords = kWgPassRows / 8;  // code words per thread and full pass
  constexpr int o_last = kWgPassRows * (kPasses - 1);
  constexpr bool kStashLast = NC > kWgRegChunks;
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
  if constexpr (kStashLast) {
#pragma unroll
    for (int i = 0; i < NL / 8; ++i)
      stash[(kWords * (kPasses - 1) + i) * kWgConsumers] = codes(o_last, i, acc, accf);
  }
  group_sync(wg);
  for (int w = 0; w < kWords * (kPasses - 1) + (kStashLast ? NL / 8 : 0); ++w)
    wg_store_codes(act, wg, lane, 8 * w + 2 * tg, stash[w * kWgConsumers]);
  if constexpr (!kStashLast) {
#pragma unroll
    for (int i = 0; i < NL / 8; ++i)
      wg_store_codes(act, wg, lane, o_last + 8 * i + 2 * tg, codes(o_last, i, acc, accf));
  }
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
    wg_slice_begin<2>(net, l, s, p, c.a_act, c.a_feat, da, db);
    wg_fence_regs(acc0);
    wg_fence_regs(acc1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kWgKSteps<2>; ++ks) {
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
  wg_slice_begin<2>(net, l, net.in_atoms[l], p, c.a_act, c.a_feat, da, db);
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
    for (int ks = 0; ks < kWgKSteps<2>; ++ks)
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
            c.smem + wg_offset<2>(64 * c.wg + 16 * warp + g + 8 * h, o)) = lo | (hi << 16);
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
// through io for the group's rays ray0.. below io.n; hook(l) while the last
// slice's MMAs are in flight.  Accumulator register 2h + e is (row 16 *
// warp + g + 8h, output 2tg + e).  Where the groups share the tile's rows
// both run the head's few MMAs and the first group stores.
template <class Ch, class Io, class Hook>
PT_HD void wg_head(const NifWg& net, int l, WgConsumer& c, int ray0, const Io& io,
                   const Hook& hook) {
  constexpr int kOp = Ch::kOp;
  WgPipe& p = c.pipe;
  const int lane = c.lane;
  typename Ch::Acc acc[4];
  wg_zero(acc);
  if constexpr (kOp == 4) {
    wg_tf32_dots<8>(net, l, c, 0, acc);
    hook(l);
  } else {
    const int slices = net.in_atoms[l] + net.f_atoms[l];
    for (int s = 0; s < slices; ++s) {
      uint64_t da, db;
      wg_slice_begin<kOp>(net, l, s, p, c.a_act, c.a_feat, da, db);
      wg_fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kWgKSteps<kOp>; ++ks) wg_mma<Ch, 8>(acc, da + 2 * ks, db + 2 * ks);
      wg_commit();
      if (s == slices - 1) hook(l);
      wg_wait<0>();
      wg_fence_regs(acc);
      wg_release(p.empty, p.stage, lane);
      wg_advance(net, p);
    }
  }
  const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, tg = lane & 3;
  if (2 * tg >= Ch::kHeadOutputs || (kWgSplit<kOp> && c.wg)) return;
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

// The bytes of one fill of layer l's slices: a pass's rows of a layer in
// passes (the 8-bit skip layer's kWgPassRows, a wider layer's
// kWgPassChunks chunks; the last pass may take fewer), else the slice.
__host__ __device__ inline int wg_fill_bytes(const NifWg& net, int l) {
  const int nc = net.chunks[l], passes = net.passes[l];
  return passes > 1 ? net.slice_bytes[l] / nc * ((nc + passes - 1) / passes)
                    : net.slice_bytes[l];
}

// The stream of slices: one producer thread walks each tile's slices
// (layer by layer; a layer of several passes once per pass, that pass's
// rows of each slice; a tf32 layer with a lo part each slice's hi then lo
// image) through the ring.
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
      const int step = wg_fill_bytes(net, l);  // a pass's rows of each slice
      const unsigned char* const srcs[2] = {(const unsigned char*)net.w[l],
                                            (const unsigned char*)net.w_lo[l]};
      const int halves = net.w_lo[l] ? 2 : 1;  // the tf32 chain's lo slice after each hi one
      for (int pass = 0; pass < passes; ++pass) {
        const uint32_t bytes = (uint32_t)min(step, slice - pass * step);
        for (int s = 0; s < slices; ++s) {
          for (int half = 0; half < halves; ++half) {
            if (!wait_free(empty + 8 * stage, phase ^ 1)) return false;
            mbar_expect_tx(full + 8 * stage, bytes);
            bulk_load(ring + stage * net.stage_bytes,
                      srcs[half] + (size_t)s * slice + (size_t)pass * step, bytes,
                      full + 8 * stage);
            ++issued;
            if (++stage == net.stages) {
              stage = 0;
              phase ^= 1;
            }
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

template <int kOp>
PT_HD WgConsumer wg_consumer(const NifWg& net, const WgBlock& b) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const uint32_t rows = wg_row0<kOp>(wg) * kWgRowBytes<kOp>;  // the group's A
  return {b.smem, b.s0 + rows,  // activations at offset 0
          b.s0 + net.smem_feat + rows, wg, tid & 127, tid & 31,
          WgPipe{b.full, b.empty, b.s0 + net.smem_ring, 0, 0}};
}

// Feature f of row `row` into the feature atoms: bf16, f32 (the tf32
// chain splits it as it reads it), or the s8 code on the constant 1/127
// grid, clip(rint(f * 127), -127, 127).
template <int kOp>
PT_HD void wg_put_feature(unsigned char* feat, int row, int k, float f) {
  if constexpr (kOp == 1)
    feat[wg_offset<1>(row, k)] =
        (uint8_t)(int8_t)(int)fminf(fmaxf(rintf(f * 127.0f), -127.0f), 127.0f);
  else if constexpr (kOp == 4)
    *reinterpret_cast<float*>(feat + wg_offset<4>(row, k)) = f;
  else
    *reinterpret_cast<uint16_t*>(feat + wg_offset<2>(row, k)) = f32_to_bf16(f);
}

// The Fourier features [sin u 2^j | sin v 2^j | cos u 2^j | cos v 2^j] of
// this warpgroup's 64 rows, from su / sv (its rows' u and v); where the
// groups share the rows, both groups' threads encode them.
template <int kOp>
PT_HD void wg_encode(const NifWg& net, const WgConsumer& c, const float* su, const float* sv) {
  constexpr bool split = kWgSplit<kOp>;
  const int E = net.embed_dim;
  unsigned char* const feat = c.smem + net.smem_feat;
  for (int idx = split ? c.t + 128 * c.wg : c.t; idx < 64 * 2 * E; idx += split ? 256 : 128) {
    const int r = idx & 63, rest = idx >> 6, axis = rest & 1, j = rest >> 1;
    float s, co;
    fourier(axis ? sv[r] : su[r], j, &s, &co);
    const int row = wg_row0<kOp>(c.wg) + r;
    wg_put_feature<kOp>(feat, row, axis * E + j, s);
    wg_put_feature<kOp>(feat, row, 2 * E + axis * E + j, co);
  }
  fence_proxy_async();
  wg_sync<kOp>(c.wg);
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
      wg_head<Ch>(net, l, c, ray0, io, hook);
      continue;
    }
    if constexpr (kWgSplit<Ch::kOp>) {  // the first group ceil(nc / 2) chunks, the second the rest
      const int c0 = c.wg ? (nc + 1) / 2 : 0;
      switch (c.wg ? nc / 2 : (nc + 1) / 2) {
        case 0: wg_hidden_tf32<Ch, 0>(net, l, c, hook, c0); break;
        case 1: wg_hidden_tf32<Ch, 1>(net, l, c, hook, c0); break;
        case 2: wg_hidden_tf32<Ch, 2>(net, l, c, hook, c0); break;
        default: wg_hidden_tf32<Ch, 3>(net, l, c, hook, c0); break;
      }
    } else {
      if constexpr (Ch::kInt8) {  // the skip layer: two dots
        if (net.in_atoms[l] && net.f_atoms[l]) {
          switch (nc) {
            case 1: wg_skip<Ch, 1>(net, l, c, hook); break;
            case 2: wg_skip<Ch, 2>(net, l, c, hook); break;
            case 3: wg_skip<Ch, 3>(net, l, c, hook); break;
            case 4: wg_skip<Ch, 4>(net, l, c, hook); break;
            case 5: wg_skip<Ch, 5>(net, l, c, hook); break;
            default:
              if constexpr (Ch::kMaxChunks > 5) wg_skip<Ch, 6>(net, l, c, hook);
              break;
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
            default: wg_skip_wide<Ch, 5>(net, l, c, hook); break;  // K8: the 6x320 net
          }
          continue;
        }
      }
      switch (nc) {
        case 1: wg_hidden<Ch, 1>(net, l, c, hook); break;
        case 2: wg_hidden<Ch, 2>(net, l, c, hook); break;
        case 3: wg_hidden<Ch, 3>(net, l, c, hook); break;
        case 4: wg_hidden<Ch, 4>(net, l, c, hook); break;
        case 5: wg_hidden<Ch, 5>(net, l, c, hook); break;
        default:
          if constexpr (Ch::kMaxChunks > kWgRegChunks)
            wg_hidden_passes<Ch, kWgMaxChunks>(net, l, c, hook);
          break;
      }
    }
  }
}

// One tile's chain: the encode of this warpgroup's rows (their (u, v) in
// su / sv, already visible to the group), then the layers.
template <class Ch, class Io>
PT_HD void wg_tile(const NifWg& net, WgConsumer& c, const float* su, const float* sv, int ray0,
                   const Io& io) {
  wg_encode<Ch::kOp>(net, c, su, sv);
  wg_layers<Ch>(net, c, ray0, io);
}

// The measurement stub of a tile (the reference's _stub_nif_layer) in
// this geometry: the encode as in wg_tile, then, with no copies and no
// MMAs, each row's first feature x (its bf16 or tf32 value or its s8 code)
// -> x * 0 + 1 per layer and the decode of that 1, stored through io as
// wg_head stores.
template <class Ch, class Io>
PT_HD void wg_tile_stub(const NifWg& net, const WgConsumer& c, const float* su, const float* sv,
                        int ray0, const Io& io) {
  constexpr int kOp = Ch::kOp;
  wg_encode<kOp>(net, c, su, sv);
  if (c.t >= 64 || (kWgSplit<kOp> && c.wg)) return;
  const unsigned char* const feat = c.smem + net.smem_feat;
  const int row = wg_row0<kOp>(c.wg) + c.t;
  float x;
  if constexpr (kOp == 1)
    x = (float)(int8_t)feat[wg_offset<1>(row, 0)];
  else if constexpr (kOp == 4)
    x = *reinterpret_cast<const float*>(feat + wg_offset<4>(row, 0));
  else
    x = __uint_as_float((uint32_t)*reinterpret_cast<const uint16_t*>(
                            feat + wg_offset<2>(row, 0))
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
template <int kOp, class Tile>
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

  WgConsumer c = wg_consumer<kOp>(net, b);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) tile(c, t);
}

// K2, K4 and K8's tile t of io.n rays.  An Io with kFeatures = false
// gives each ray's (u, v) (io.uv) for the encode; one with kFeatures = true
// puts io.rows precomputed feature rows (io.put).  io.store(o, ray, y)
// takes each head output.  A functor with a forced-inline call, not a
// lambda: as a lambda, the int8 tile with six-chunk layers compiled to a
// 1,160-byte stack frame and spilled in K2 and K4.
template <class Ch, class Io>
struct WgNifTile {
  const NifWg& net;
  const Io& io;
  __device__ __forceinline__ void operator()(WgConsumer& c, int tile) const {
    constexpr int kOp = Ch::kOp, kTile = kWgTileRays<kOp>;
    const int ray0 = tile * kTile + wg_row0<kOp>(c.wg);
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
      float* const su = (float*)(c.smem + net.smem_uv) + wg_row0<kOp>(c.wg);
      float* const sv = su + kWgRays;
      // Shared rows: the other group may still read the previous tile's
      // features (a head that takes them) when the first group gets here.
      if constexpr (kWgSplit<kOp>) consumers_sync();
      if (c.t < 64 && (!kWgSplit<kOp> || c.wg == 0)) {
        float u = 0.0f, v = 0.0f;
        if (ray0 + c.t < io.n) io.uv(ray0 + c.t, &u, &v);
        su[c.t] = u;
        sv[c.t] = v;
      }
      wg_sync<kOp>(c.wg);
      wg_tile<Ch>(net, c, su, sv, ray0, io);
    }
  }
};

// K2, K4 and K8's body: the tiles of io.n rays (WgNifTile).
template <class Ch, class Io>
__device__ __forceinline__ void nif_wg_tiles(const NifWg& net, const Io& io) {
  constexpr int kTile = kWgTileRays<Ch::kOp>;
  wg_tiles<Ch::kOp>(net, (io.n + kTile - 1) / kTile, WgNifTile<Ch, Io>{net, io});
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
  if (net.int8 && net.tf32) return false;
  for (int l = 0; l < net.num_layers; ++l)
    if (((uintptr_t)net.w[l] & 15) || ((uintptr_t)net.w_lo[l] & 15) ||
        (net.w_lo[l] && !net.tf32) || net.chunks[l] < 0 || net.chunks[l] > kWgMaxChunks ||
        net.passes[l] != (net.int8 && net.in_atoms[l] && net.f_atoms[l] && net.chunks[l]
                              ? (net.chunks[l] + 1) / 2
                          : !net.tf32 && net.chunks[l] > kWgRegChunks
                              ? (net.chunks[l] + kWgPassChunks - 1) / kWgPassChunks
                              : 1) ||
        wg_fill_bytes(net, l) > net.stage_bytes ||
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
  const int tile_rays = net.tf32 ? kWgTileRays<4> : kWgRays;
  const int tiles = (n + tile_rays - 1) / tile_rays;
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
