// K3, the production kernels: every RNG mode, the three chains, no stub
// (megastep.cuh holds the kernel and says what it does).
#include "megastep.cuh"

// wg: the model's chain (bf16, int8 or tf32, its int8 and tf32 flags) under
// K3's plan.
// noise != nullptr selects host noise ((samples, 4 + 4L, n) rows);
// otherwise pid != nullptr selects Sobol mode (per-lane pixel ids and
// sequence bases, prm->sobol_dims / sobol_key, Philox tail), else hardware
// (Philox) mode seeded by prm->seed0/1.  budgets (or nullptr) holds one
// count per budget_block rays; with budgets, order holds the ray blocks
// heaviest budget first and ticket one int of scratch on the device,
// zeroed here on the stream (both nullptr: ray block blockIdx.x); lum2 (or
// nullptr) receives the statistics; stamps (or nullptr) the per-block
// records (kStampWords int64 a ray block).
extern "C" int pt_megastep(const pt::TraceParams* prm, const pt::NifWg* wg, const float* sph,
                           const float* dsc, const float* cols, const float* rows,
                           const float* noise, const int* pid, const int* base,
                           const int* budgets, const int* order, int* ticket, int budget_block,
                           int samples, int n, float* rad, int* plen, float* lum2,
                           long long* stamps, void* stream) {
  if (wg == nullptr) return (int)cudaErrorInvalidValue;
  const pt::MegaArgs a{sph, dsc, cols, rows, noise, pid, base, budgets, order, ticket,
                       budget_block, samples, n, rad, plen, lum2, stamps};
  cudaStream_t s = (cudaStream_t)stream;
  if (noise) return pt::launch_megastep<pt::kRngHost, pt::kStubNone>(*prm, *wg, a, s);
  if (pid) return pt::launch_megastep<pt::kRngSobol, pt::kStubNone>(*prm, *wg, a, s);
  return pt::launch_megastep<pt::kRngPhilox, pt::kStubNone>(*prm, *wg, a, s);
}
