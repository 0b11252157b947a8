// K3's measurement stubs (ops/megastep_pallas.py::_stub_nif_layer,
// ::_stub_bounce, selected at :238-239), for utils/devtime.py's split of
// the step into env, trace and overhead: stub 1 ('nif') replaces the NIF
// chain's products by ones, 2 ('trace') the bounce by a path-length
// count, 3 ('both') both.  Built for the RNG modes a render times
// (Philox and Sobol) and the three chains (megastep_wg_kernel, whose 'nif' stub
// runs its blocks and tiles with no weight copies and no MMAs); host noise
// is not instantiated.  What the stubbed work keeps live is said at
// wg_tile_stub (nif_wgmma.cuh) and trace_ray (common.cuh).
#include "megastep.cuh"

namespace {

template <int kStub>
int launch_stub(const pt::TraceParams* prm, const pt::NifWg* wg, const pt::MegaArgs& a,
                cudaStream_t s) {
  return a.pid ? pt::launch_megastep<pt::kRngSobol, kStub>(*prm, *wg, a, s)
               : pt::launch_megastep<pt::kRngPhilox, kStub>(*prm, *wg, a, s);
}

}  // namespace

// The arguments of pt_megastep without host noise, and the stub mode.
extern "C" int pt_megastep_stub(const pt::TraceParams* prm, const pt::NifWg* wg,
                                const float* sph, const float* dsc, const float* cols,
                                const float* rows, const int* pid, const int* base,
                                const int* budgets, const int* order, int* ticket,
                                int budget_block, int samples, int n, float* rad, int* plen,
                                float* lum2, int stub, void* stream) {
  if (wg == nullptr) return (int)cudaErrorInvalidValue;
  const pt::MegaArgs a{sph, dsc, cols, rows, nullptr, pid, base, budgets, order, ticket,
                       budget_block, samples, n, rad, plen, lum2, nullptr};
  cudaStream_t s = (cudaStream_t)stream;
  switch (stub) {
    case pt::kStubNif:
      return launch_stub<pt::kStubNif>(prm, wg, a, s);
    case pt::kStubTrace:
      return launch_stub<pt::kStubTrace>(prm, wg, a, s);
    case pt::kStubBoth:
      return launch_stub<pt::kStubBoth>(prm, wg, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
