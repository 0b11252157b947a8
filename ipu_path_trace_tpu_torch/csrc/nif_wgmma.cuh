// The bf16 NIF chain on Hopper's warpgroup MMA, for the kernels of K2 and
// K4 (nif.cu) and the bf16 K3 (megastep.cuh): encode -> layers -> decode
// for tiles of kWgRays rays, the weights streamed through shared memory by
// bulk copies.  It computes what nif_dev.cuh::nif_tile computes -
// encode_bf16's direct sincosf angles, bf16 weights and activations with
// f32 accumulation, f32 bias, ReLU and a round to bf16 between layers, the
// skip layer's concat(trunk, feats) as the tail of its K dimension, the f32
// decode y * max + mean (exp when log-tone-mapped) - in another order of
// f32 sums.
//
// The pieces, in the order a kernel calls them: wg_block and wg_setup (the
// plan's shared memory, the ring's barriers, the features' zero columns),
// then the role split wg_producer_role (setmaxnreg; the producer thread
// runs a WgProducer), then per tile wg_tile (encode from the tile's (u, v),
// the layers, the head storing through an Io).  K2 and K4 walk a fixed
// list of tiles (nif_wg_tiles); K3 decides per sample which tiles to shade
// and streams them through wg_stream (megastep.cuh says how).
//
// Why: the mma.sync chain (nif_layers) runs 64-ray tiles whose warps load
// their B fragments from L2 with 4-byte __ldg's, so each 64-ray tile reads
// the whole ~1.1 MB of weights from L2 and the warps mostly wait on it
// (~12% of dense bf16 peak).  Here a tile is 128 rays, the weights arrive
// in 64-input K-slices by cp.async.bulk into a ring in shared memory, and
// wgmma (the only route to Hopper's full tensor-core rate) reads both
// operands from there.
//
// Roles (kWgThreads = 384): two consumer warpgroups, each owning 64 rays of
// the tile (wgmma's M), and a producer warpgroup one thread of which walks
// the same slice sequence (layer by layer, tile after tile: in K2 and K4
// the block is persistent over tiles blockIdx.x + i * gridDim.x) and keeps
// the ring's `stages` slices filled: full[s] completes on the bulk copy's bytes,
// empty[s] on one arrival per consumer warp once its MMAs on the slice have
// completed.  A consumer issues a slice's MMAs while the previous slice's
// are still in flight (wgmma.wait_group 1), so it holds two stages.
// Per k16 step a hidden layer of NC 64-wide output chunks is one wgmma
// m64nNk16 of N = 64 min(NC, 4) plus, for a fifth chunk, one of N = 64;
// the head is one m64n8k16 (3 outputs padded to 8).
//
// Layouts: every wgmma operand is K-major with the 128-byte swizzle.  An
// "atom" is 64 K values (128 bytes) of a set of rows; 16-byte chunk c of
// row r sits at chunk c ^ (r % 8) of the row (wg_offset), 8-row groups
// 1024 bytes apart (the descriptor's stride offset), and the k16 steps
// inside an atom advance the descriptor by 32 bytes.
//   * weights: a slice is one layer's rows (outputs, padded to 64 for a
//     hidden layer, to 8 for the head) x 64 inputs, packed on the host into
//     exactly this image (ops/nif.py::wgmma_operands), so one copy of
//     rows * 128 bytes fills a stage.  Input columns past the layer's
//     fan-in are zero;
//   * activations: [atom][128 rays][128 B], updated in place: a warpgroup
//     reads only its own 64 rows as A, and it overwrites them with the
//     layer's outputs after its last wgmma of the layer has completed,
//     holding all of a layer's outputs (up to 320) as 160 f32
//     accumulators per thread;
//   * features: their own atoms, written by the encode, the columns from
//     4E up zeroed once per block.  Layer 0 reads them as its input, the
//     skip layer as the slices after its trunk slices.
// Each layer's K is its fan-in rounded up to 64: the padded weight columns
// are zero and so are the activations there (the epilogue writes zeros for
// the padded outputs, which have zero weights and zero bias).
//
// Shared-memory plan of K2 and K4, canonical 6x320 net (E = 12), computed
// in ops/nif.py::wgmma_plan and carried here in NifWg (K3's, with its own
// tail after the barriers, is in megastep.cuh):
//   activations 5 atoms x 16,384 B   =  81,920 B
//   features    1 atom  x 16,384 B   =  16,384 B
//   ring        3 stages x 40,960 B  = 122,880 B  (320 rows x 128 B)
//   barriers 64 B, (u, v) 1,024 B, 1,024-B alignment slack: 223,296 B of
//   the 232,448 a block may use, so one block per SM.
// Registers: a block of 384 threads starts at 168 per thread (65,536 /
// 384, rounded down to 8); the producer warpgroup gives its surplus back
// (setmaxnreg.dec to kWgProducerRegs = 40) and the consumers take it
// (setmaxnreg.inc to kWgConsumerRegs = 232: 128 x 40 + 256 x 232 =
// 64,512), room for the 160 accumulators.  With a single producer warp
// ptxas still sizes the block as three warpgroups and, held to 168
// registers, spills the accumulators.
// L2 traffic: a 128-ray tile reads its slices once, 1,111,040 B for the
// canonical net (padding included), so ~9.6 GB per 1,104,000-lane
// sample (8,625 tiles) against ~18.8 GB for 64-ray tiles.  That is 64
// multiply-adds per weight byte read: at the tensor cores' peak an SM
// would read ~32 B per clock from L2, ~7.7 TB/s over 132 SMs, more than L2
// gives, so L2 bounds this design (PERF.md); a 2-block cluster sharing
// each slice by a multicast copy would halve the reads.
//
// A wait on an mbarrier traps after ~2^34 clocks (seconds) instead of
// hanging the card, should a phase ever be missed.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "nif_dev.cuh"

namespace pt {

constexpr int kWgRays = 128;  // rays per tile (block)
constexpr int kWgGroups = 2;  // consumer warpgroups, 64 rays each
constexpr int kWgThreads = 128 * (kWgGroups + 1);  // + the producer warpgroup
constexpr int kWgProducerRegs = 40;  // setmaxnreg of the producer warpgroup
constexpr int kWgConsumerRegs = 232;  // and of the consumers
constexpr int kWgMaxStages = 4;
constexpr int kWgMaxChunks = 5;  // 64-wide output chunks of a hidden layer: 320 outputs
constexpr int kWgAtomBytes = kWgRays * 128;  // 64 K values of the tile's rows
constexpr int kWgGroupBytes = 64 * 128;  // a warpgroup's 64 rows of an atom (its A)
constexpr int kWgSmemLimit = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr long long kWgHangClocks = 1ll << 34;

// Mirrored by ops/_lib.py::NifWg (ctypes); keep the field order.  Filled
// by ops/nif.py::wg_struct from wgmma_plan and wgmma_operands.
struct NifWg {
  int num_layers, embed_dim, log_flag;
  int stages, stage_bytes;  // ring stages and the bytes of one (the largest slice)
  int feat_atoms;  // atoms of the features
  int smem_feat, smem_ring, smem_bar, smem_uv, smem_bytes;  // plan offsets and total
  int chunks[kNifMaxLayers];  // 64-wide output chunks (hidden); 0 = the head's n8 tile
  int in_atoms[kNifMaxLayers];  // K-slices read from the activations
  int f_atoms[kNifMaxLayers];  // K-slices read from the features (layer 0, skip layer)
  int slice_bytes[kNifMaxLayers];  // rows * 128
  const void* w[kNifMaxLayers];  // the layer's slices, back to back (bf16 images)
  const float* b[kNifMaxLayers];  // f32 bias padded with zeros to the layer's rows
  float max_v;
  float mean[3];
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

// K-major, 128-byte swizzle: start address, leading offset 16 B (unused
// with this swizzle), 1024 B between 8-row groups.
PT_HD uint64_t wg_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
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

// d[64 x N] += A[64 x 16] * B[16 x N], both from shared memory; thread
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

// Byte offset of (row, k) in a K-major, 128-byte-swizzled operand whose
// atoms hold kWgRays rows (activations and features).
PT_HD int wg_offset(int row, int k) {
  return (k >> 6) * kWgAtomBytes + row * 128 + ((((k >> 3) & 7) ^ (row & 7)) << 4) +
         ((k & 7) << 1);
}

// ---- the chain ---------------------------------------------------------

// A consumer's place in the ring (the producer's sequence of slices).
struct WgPipe {
  uint32_t full, empty, ring;
  int stage;
  uint32_t phase;
};

// Waits for the ring's next slice, the s-th of layer l (slices 0..
// in_atoms-1 read this warpgroup's activation rows, the rest its feature
// rows), and gives the A and B descriptors of its first k16 step.
PT_HD void wg_slice_begin(const NifWg& net, int l, int s, const WgPipe& p, uint32_t a_act,
                          uint32_t a_feat, uint64_t& da, uint64_t& db) {
  mbar_wait(p.full + 8 * p.stage, p.phase);
  __syncwarp();  // wgmma is .aligned: the warp issues it converged
  const int ia = net.in_atoms[l];
  da = wg_desc(s < ia ? a_act + s * kWgAtomBytes : a_feat + (s - ia) * kWgAtomBytes);
  db = wg_desc(p.ring + p.stage * net.stage_bytes);
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

// Stores relu(acc + bias) as bf16 for outputs o0.. o0 + N - 1 of this
// warp's rows, into the activations (in place).
template <int N>
PT_HD void wg_store_relu(const float (&acc)[N / 2], const float* b, int o0, unsigned char* act,
                         int wg, int lane) {
  const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int o = o0 + 8 * i + 2 * tg;
    const float2 bias = __ldg(reinterpret_cast<const float2*>(b + o));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * wg + 16 * warp + g + 8 * h;
      const uint32_t lo = f32_to_bf16(fmaxf(acc[4 * i + 2 * h] + bias.x, 0.0f));
      const uint32_t hi = f32_to_bf16(fmaxf(acc[4 * i + 2 * h + 1] + bias.y, 0.0f));
      *reinterpret_cast<uint32_t*>(act + wg_offset(row, o)) = lo | (hi << 16);
    }
  }
}

template <int N>
PT_HD void wg_zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
}

// Hidden layer l with NC 64-wide output chunks, as one wgmma of N0 =
// 64 min(NC, 4) outputs per k16 step, plus one of N1 = 64 for a fifth
// chunk (so A is read from shared memory once or twice per step, not NC
// times); then bias + ReLU -> bf16 over this warpgroup's rows of the
// activations, in place.  One slice's MMAs stay in flight while the next
// slice's are issued (wait_group 1), and a slice returns to the producer
// when its MMAs have completed.
template <int NC>
PT_HD void wg_hidden(const NifWg& net, int l, WgPipe& p, unsigned char* act, uint32_t a_act,
                     uint32_t a_feat, int wg, int lane) {
  constexpr int N0 = 64 * (NC > 4 ? 4 : NC), N1 = 64 * NC - N0;
  float acc0[N0 / 2], acc1[N1 ? N1 / 2 : 2];
  wg_zero(acc0);
  wg_zero(acc1);
  const int slices = net.in_atoms[l] + net.f_atoms[l];
  int held = -1;  // the stage whose MMAs may still be in flight
  for (int s = 0; s < slices; ++s) {
    uint64_t da, db;
    wg_slice_begin(net, l, s, p, a_act, a_feat, da, db);
    wg_fence_regs(acc0);
    wg_fence_regs(acc1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma<N0>(acc0, da + 2 * ks, db + 2 * ks);
      if constexpr (N1 > 0) wgmma<N1>(acc1, da + 2 * ks, db + 2 * ks + 8 * N0);
    }
    wg_commit();
    wg_wait<1>();
    wg_fence_regs(acc0);
    wg_fence_regs(acc1);
    if (held >= 0) wg_release(p.empty, held, lane);
    held = p.stage;
    wg_advance(net, p);
  }
  wg_wait<0>();
  wg_fence_regs(acc0);
  wg_fence_regs(acc1);
  wg_release(p.empty, held, lane);
  group_sync(wg);  // every warp's MMAs of this layer are done before rows are overwritten
  wg_store_relu<N0>(acc0, net.b[l], 0, act, wg, lane);
  if constexpr (N1 > 0) wg_store_relu<N1>(acc1, net.b[l], N0, act, wg, lane);
  fence_proxy_async();
  group_sync(wg);
}

// The head (last layer, outputs padded to 8) and the f32 decode, stored
// through io for the tile's rays below io.n.  Accumulator register 2h + e
// is (row 16 * warp + g + 8h, output 2tg + e).
template <class Io>
PT_HD void wg_head(const NifWg& net, int l, WgPipe& p, uint32_t a_act, uint32_t a_feat, int ray0,
                   int lane, const Io& io) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int slices = net.in_atoms[l] + net.f_atoms[l];
  for (int s = 0; s < slices; ++s) {
    uint64_t da, db;
    wg_slice_begin(net, l, s, p, a_act, a_feat, da, db);
    wg_fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma<8>(acc, da + 2 * ks, db + 2 * ks);
    wg_commit();
    wg_wait<0>();
    wg_fence_regs(acc);
    wg_release(p.empty, p.stage, lane);
    wg_advance(net, p);
  }
  const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, tg = lane & 3;
  if (tg > 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ray = ray0 + 16 * warp + g + 8 * h;
    if (ray >= io.n) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = 2 * tg + e;
      if (o > 2) continue;
      const float mean = o == 0 ? net.mean[0] : (o == 1 ? net.mean[1] : net.mean[2]);
      const float z = (acc[2 * h + e] + net.b[l][o]) * net.max_v + mean;
      io.store(o, ray, net.log_flag ? expf(z) : z);
    }
  }
}

// The stream of slices: one producer thread walks each tile's slices
// (layer by layer) through the ring.
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
      const int slices = net.in_atoms[l] + net.f_atoms[l];
      const uint32_t bytes = (uint32_t)net.slice_bytes[l];
      const unsigned char* const src = (const unsigned char*)net.w[l];
      for (int s = 0; s < slices; ++s) {
        if (!wait_free(empty + 8 * stage, phase ^ 1)) return false;
        mbar_expect_tx(full + 8 * stage, bytes);
        bulk_load(ring + stage * net.stage_bytes, src + (size_t)s * bytes, bytes, full + 8 * stage);
        ++issued;
        if (++stage == net.stages) {
          stage = 0;
          phase ^= 1;
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
  for (int i = threadIdx.x; i < net.feat_atoms * kWgAtomBytes / 16; i += kWgThreads)
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

// A consumer thread's place: its warpgroup's rows of the activations and
// features (wgmma's A), and its ring position.
struct WgConsumer {
  unsigned char* smem;
  uint32_t a_act, a_feat;
  int wg, t, lane;
  WgPipe pipe;
};

PT_HD WgConsumer wg_consumer(const NifWg& net, const WgBlock& b) {
  const int tid = threadIdx.x, wg = tid >> 7;
  return {b.smem, b.s0 + wg * kWgGroupBytes,  // activations at offset 0
          b.s0 + net.smem_feat + wg * kWgGroupBytes, wg, tid & 127, tid & 31,
          WgPipe{b.full, b.empty, b.s0 + net.smem_ring, 0, 0}};
}

// The Fourier features [sin u 2^j | sin v 2^j | cos u 2^j | cos v 2^j] of
// this warpgroup's 64 rows, from su / sv (its rows' u and v).
PT_HD void wg_encode(const NifWg& net, const WgConsumer& c, const float* su, const float* sv) {
  const int E = net.embed_dim;
  unsigned char* const feat = c.smem + net.smem_feat;
  for (int idx = c.t; idx < 64 * 2 * E; idx += 128) {
    const int r = idx & 63, rest = idx >> 6, axis = rest & 1, j = rest >> 1;
    float s, co;
    fourier(axis ? sv[r] : su[r], j, &s, &co);
    const int row = 64 * c.wg + r;
    *reinterpret_cast<uint16_t*>(feat + wg_offset(row, axis * E + j)) = f32_to_bf16(s);
    *reinterpret_cast<uint16_t*>(feat + wg_offset(row, 2 * E + axis * E + j)) = f32_to_bf16(co);
  }
  fence_proxy_async();
  group_sync(c.wg);
}

// One tile's chain, run by both consumer warpgroups: the encode of this
// warpgroup's rows (their (u, v) in su / sv, already visible to the
// group), the layers, and the head stored through io for rays ray0 (this
// group's first row) + 0..63.
template <class Io>
PT_HD void wg_tile(const NifWg& net, WgConsumer& c, const float* su, const float* sv, int ray0,
                   const Io& io) {
  wg_encode(net, c, su, sv);
  for (int l = 0; l < net.num_layers; ++l) {
    switch (net.chunks[l]) {
      case 0: wg_head(net, l, c.pipe, c.a_act, c.a_feat, ray0, c.lane, io); break;
      case 1: wg_hidden<1>(net, l, c.pipe, c.smem, c.a_act, c.a_feat, c.wg, c.lane); break;
      case 2: wg_hidden<2>(net, l, c.pipe, c.smem, c.a_act, c.a_feat, c.wg, c.lane); break;
      case 3: wg_hidden<3>(net, l, c.pipe, c.smem, c.a_act, c.a_feat, c.wg, c.lane); break;
      case 4: wg_hidden<4>(net, l, c.pipe, c.smem, c.a_act, c.a_feat, c.wg, c.lane); break;
      default:
        wg_hidden<kWgMaxChunks>(net, l, c.pipe, c.smem, c.a_act, c.a_feat, c.wg, c.lane);
        break;
    }
  }
}

// The measurement stub of a tile (nif_dev.cuh::nif_chain_stub in this
// geometry): the encode as in wg_tile, then, with no copies and no MMAs,
// each row's first feature x -> x * 0 + 1 per layer and the decode of
// that 1, stored through io as wg_head stores.
template <class Io>
PT_HD void wg_tile_stub(const NifWg& net, const WgConsumer& c, const float* su, const float* sv,
                        int ray0, const Io& io) {
  wg_encode(net, c, su, sv);
  if (c.t >= 64) return;
  const unsigned char* const feat = c.smem + net.smem_feat;
  float x = __uint_as_float(
      (uint32_t)*reinterpret_cast<const uint16_t*>(feat + wg_offset(64 * c.wg + c.t, 0)) << 16);
  for (int l = 0; l < net.num_layers; ++l) x = x * 0.0f + 1.0f;
#pragma unroll
  for (int o = 0; o < 3; ++o) {  // decode at f32: y * max + mean, exp if log
    const float z = x * net.max_v + net.mean[o];
    io.store(o, ray0 + c.t, net.log_flag ? expf(z) : z);
  }
}

// K2 and K4's body: io gives each ray's (u, v) (io.uv) and takes each
// decoded network output (io.store(o, ray, y)); io.n rays, the block
// persistent over tiles blockIdx.x + i * gridDim.x.  Launch with
// kWgThreads threads and net.smem_bytes of dynamic shared memory.
template <class Io>
__device__ __forceinline__ void nif_wg_tiles(const NifWg& net, const Io& io) {
  const WgBlock b = wg_block(net);
  const int tiles = (io.n + kWgRays - 1) / kWgRays;
  wg_setup(net, b);
  __syncthreads();
  if (wg_producer_role([&] {
        WgProducer prod{b.full, b.empty, b.s0 + net.smem_ring, 0, 0, 0};
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
          prod.chain(net, [](uint32_t bar, uint32_t parity) {
            mbar_wait(bar, parity);
            return true;
          });
      }))
    return;

  WgConsumer c = wg_consumer(net, b);
  float* const su = (float*)(b.smem + net.smem_uv) + 64 * c.wg;
  float* const sv = su + kWgRays;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ray0 = tile * kWgRays + 64 * c.wg;
    if (c.t < 64) {
      float u = 0.0f, v = 0.0f;
      if (ray0 + c.t < io.n) io.uv(ray0 + c.t, &u, &v);
      su[c.t] = u;
      sv[c.t] = v;
    }
    group_sync(c.wg);
    wg_tile(net, c, su, sv, ray0, io);
  }
}

// K2's ends: equirect (u, v) of the escape direction; bgr -> rgb times the
// escape weights.
struct WgShadeIo {
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
        net.chunks[l] < 0 || net.chunks[l] > kWgMaxChunks)
      return false;
  return true;
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
