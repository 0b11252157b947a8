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

namespace pt {
namespace {

template <int kStub>
int launch_stub(const TraceParams& prm, const NifWg& net, const MegaArgs& a, cudaStream_t s) {
  return a.pid ? launch_megastep<kRngSobol, kStub>(prm, net, a, s)
               : launch_megastep<kRngPhilox, kStub>(prm, net, a, s);
}

}  // namespace

int launch_megastep_stub(const TraceParams& prm, const NifWg& net, const MegaArgs& a, int stub,
                         cudaStream_t s) {
  if (a.noise) return (int)cudaErrorInvalidValue;
  switch (stub) {
    case kStubNif:
      return launch_stub<kStubNif>(prm, net, a, s);
    case kStubTrace:
      return launch_stub<kStubTrace>(prm, net, a, s);
    case kStubBoth:
      return launch_stub<kStubBoth>(prm, net, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace pt
