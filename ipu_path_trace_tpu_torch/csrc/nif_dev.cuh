// Device code of the NIF env light that every NIF kernel shares: the bf16
// rounding of an activation, the equirect (u, v) of an escaped ray and the
// Fourier encode's angles.  The chains themselves - K2, K3, K4, K6, K7 and
// K8 in all their variants - run on wgmma (nif_wgmma.cuh, which includes
// this file).
//
// The encode uses sincosf on the direct angles 2^j * 2 (u - 1) (exact in
// f32), like the trainer's models/nif.fourier_features, instead of the TPU
// kernel's double-angle recurrence; acos/atan2 are the true functions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace pt {

constexpr int kNifMaxLayers = 16;

PT_HD uint16_t f32_to_bf16(float x) {  // round to nearest even, NaN kept quiet
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return (uint16_t)((u >> 16) | 0x40u);
  return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

PT_HD uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// Equirect (u, v) of an escape direction; non-escaped lanes (zero
// directions) map to (0, 0) like the reference's PreProcessEscapedRays.
PT_HD void equirect_uv(float dx, float dy, float dz, float azimuth, float* u, float* v) {
  const bool escaped = dx * dx + dy * dy + dz * dz > 0.5f;
  const float theta = acosf(fminf(fmaxf(dy, -1.0f), 1.0f));
  float phi = atan2f(dz, dx) + azimuth;
  phi = phi < 0.0f ? phi + kTwoPi : (phi > kTwoPi ? phi - kTwoPi : phi);
  *u = escaped ? theta * kInvPi : 0.0f;
  *v = escaped ? phi * kInvTwoPi : 0.0f;
}

// sin and cos of octave j of coordinate `coord`: angle 2^j * 2 (coord - 1).
PT_HD void fourier(float coord, int j, float* s, float* c) {
  sincosf((2.0f * (coord - 1.0f)) * (float)(1 << j), s, c);
}

}  // namespace pt
