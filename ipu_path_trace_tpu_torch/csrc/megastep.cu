// K3, the production kernels: every RNG mode, both chains, no stub
// (megastep.cuh holds the kernels and says what they do).
#include "megastep.cuh"

// Exactly one of net (an int8 model: megastep_kernel, mma.sync s8) and wg
// (a bf16 model: megastep_wg_kernel, wgmma) is given; a bf16 NifNet is
// refused.  noise != nullptr selects host noise ((samples, 4 + 4L, n)
// rows); otherwise pid != nullptr selects Sobol mode (per-lane pixel ids
// and sequence bases, prm->sobol_dims / sobol_key, Philox tail), else
// hardware (Philox) mode seeded by prm->seed0/1.  budgets (or nullptr)
// holds one count per budget_block rays; lum2 (or nullptr) receives the
// statistics.
extern "C" int pt_megastep(const pt::TraceParams* prm, const pt::NifNet* net, const pt::NifWg* wg,
                           const float* sph, const float* dsc, const float* cols,
                           const float* rows, const float* noise, const int* pid, const int* base,
                           const int* budgets, int budget_block, int samples, int n,
                           int env_skip, float* rad, int* plen, float* lum2, void* stream) {
  const pt::MegaArgs a{sph, dsc, cols, rows, noise, pid, base, budgets,
                       budget_block, samples, n, env_skip, rad, plen, lum2};
  cudaStream_t s = (cudaStream_t)stream;
  if (noise) return pt::launch_chain<pt::kRngHost, pt::kStubNone>(*prm, net, wg, a, s);
  if (pid) return pt::launch_chain<pt::kRngSobol, pt::kStubNone>(*prm, net, wg, a, s);
  return pt::launch_chain<pt::kRngPhilox, pt::kStubNone>(*prm, net, wg, a, s);
}
