// K3, the production kernels: every RNG mode, the three chains, no stub
// (megastep.cuh holds the kernel and says what it does).
#include "megastep.cuh"

// K3's one entry.  wg: the model's chain (bf16, int8 or tf32, its int8 and
// tf32 flags) under K3's plan; a: the rest (megastep.cuh MegaArgs).
// a->noise != nullptr selects host noise ((samples, 4 + 4L, n) rows);
// otherwise a->pid != nullptr selects Sobol mode (per-lane pixel ids and
// sequence bases, prm->sobol_dims / sobol_key, Philox tail), else hardware
// (Philox) mode seeded by prm->seed0/1.  a->budgets (or nullptr) holds one
// count per a->budget_block rays; with budgets, a->order holds the ray
// blocks heaviest budget first and a->ticket one int of scratch on the
// device, zeroed here on the stream (both nullptr: ray block blockIdx.x);
// a->lum2 (or nullptr) receives the statistics; a->stamps (or nullptr) the
// per-block records (kStampWords int64 a ray block).  stub 0 runs the
// production kernels; 1-3 (StubMode) a measurement stub
// (launch_megastep_stub: no host noise, no record written).
extern "C" int pt_megastep(const pt::TraceParams* prm, const pt::NifWg* wg,
                           const pt::MegaArgs* a, int stub, void* stream) {
  if (prm == nullptr || wg == nullptr || a == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (stub != pt::kStubNone) return pt::launch_megastep_stub(*prm, *wg, *a, stub, s);
  if (a->noise) return pt::launch_megastep<pt::kRngHost, pt::kStubNone>(*prm, *wg, *a, s);
  if (a->pid) return pt::launch_megastep<pt::kRngSobol, pt::kStubNone>(*prm, *wg, *a, s);
  return pt::launch_megastep<pt::kRngPhilox, pt::kStubNone>(*prm, *wg, *a, s);
}
