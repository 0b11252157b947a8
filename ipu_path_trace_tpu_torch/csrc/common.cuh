// Device code shared by the trace (trace.cu) and megastep (megastep.cuh)
// kernels: per-ray camera generation, scene intersection and the bounce
// loop, plus the in-kernel Philox4x32-10 generator.
//
// Semantics are the reference's bounce (ipu_path_trace_tpu/render/
// wavefront.py::bounce_body, mirrored by ops/trace_pallas.py::bounce_once)
// evaluated for one ray per thread.  The TPU evaluates every bounce for a
// whole block of lanes under masks and skips dead blocks with two
// lax.conds; here a ray leaves its loop at the bounce it dies on.  A dead
// lane's bounce is exactly the identity in the reference, so the exit is
// exact, not an approximation.
//
// Random numbers: host-noise mode reads the rows of a (4 + 4L, P) array
// ([0:2] AA jitter already distributed, [2:4] lens uniforms,
// [4+4b : 8+4b] bounce b); hardware mode draws group g of four 24-bit
// uniforms in (0, 1] from Philox4x32-10 with key = the two seed words and
// counter = (ray index, sample index, g, 0).  Group 0 is the camera
// (jitter pair + lens pair), group 1 + b is bounce b.  The stream does not
// depend on the launch geometry, so the trace and megastep kernels draw
// identical numbers for the same seed, and ops/trace.py::philox_noise
// replays it on the host.  Sobol mode (SobolNoise) takes the first
// prm.sobol_dims dims (whole groups) from the lane's Owen-scrambled Sobol
// sequence (render/qmc.py) and the groups past them from Philox as above.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sobol_dirs.cuh"

#define PT_HD __device__ __forceinline__

namespace pt {

constexpr float kEps = 3e-5f;  // == core/geometry.EPS
constexpr float kTwoPi = 6.283185307179586f;  // f32(2 pi)
constexpr float kInvPi = 0.3183098861837907f;  // f32(1 / pi)
constexpr float kInvTwoPi = 0.15915494309189535f;  // f32(1 / (2 pi))
constexpr float kDiffuseScale = 0.1f;
constexpr float kRefractWeight = 1.15f;
constexpr int kSphereF = 12;  // cx cy cz r | cr cg cb | er eg eb | emissive material
constexpr int kDiscF = 15;  // nx ny nz cx cy cz r | cr cg cb | er eg eb | emissive material

// Mirrored by ops/_lib.py::TraceParams (ctypes); keep the field order.
struct TraceParams {
  float tanfov_x, tanfov_y, aa_scale, refr_index, stop_prob, aperture, focal, azimuth;
  int width, height, max_path_length, roulette_depth, aa_type, num_s, num_d;
  int sobol_dims;  // Sobol mode: leading noise rows from the sequence (a multiple of 4)
  uint32_t seed0, seed1;
  uint32_t sobol_key, pad0;  // Sobol mode: the render-wide scramble key
};

// Noise source of a kernel instantiation: Philox (hardware), host rows,
// or the Owen-Sobol prefix with a Philox tail.
enum RngMode { kRngPhilox = 0, kRngHost = 1, kRngSobol = 2 };

enum AaType { kAaUniform = 0, kAaNormal = 1, kAaTruncatedNormal = 2 };

struct V3 {
  float x, y, z;
};
PT_HD V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
PT_HD V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
PT_HD V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
PT_HD V3 cwise(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
PT_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
PT_HD V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
PT_HD V3 normalized(V3 a) { return a * (1.0f / sqrtf(dot(a, a))); }

// ---------------------------------------------------------------- RNG ----
struct U4 {
  uint32_t x, y, z, w;
};

PT_HD U4 philox4x32_10(U4 c, uint32_t k0, uint32_t k1) {
  const uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  const uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

// Top 24 bits -> (0, 1], as the reference kernel's uniforms.
PT_HD float u24(uint32_t bits) { return (float)((bits >> 8) + 1u) * (1.0f / 16777216.0f); }

struct PhiloxNoise {
  static constexpr bool kJitterDistributed = false;
  uint32_t k0, k1, lane, sample;
  PT_HD void group(int g, float out[4]) const {
    const U4 r = philox4x32_10(U4{lane, sample, (uint32_t)g, 0u}, k0, k1);
    out[0] = u24(r.x);
    out[1] = u24(r.y);
    out[2] = u24(r.z);
    out[3] = u24(r.w);
  }
};

struct HostNoise {
  static constexpr bool kJitterDistributed = true;
  const float* lane0;  // &noise[0][p]
  long long stride;  // row stride (P)
  PT_HD void group(int g, float out[4]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = __ldg(lane0 + (long long)(4 * g + j) * stride);
  }
};

// Owen-scrambled Sobol (render/qmc.py, in uint32 registers).
PT_HD uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

PT_HD uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

struct SobolNoise {
  static constexpr bool kJitterDistributed = false;
  uint32_t h;  // scrambled index word: laine_karras(reverse_bits(idx), pixel seed)
  uint32_t key;
  int dims;
  PhiloxNoise tail;  // groups at and past dims / 4

  // Dimension d of the sample: the XOR of the reversed direction numbers
  // of h's set bits, then the dimension's output scramble.  The sum runs
  // over all 32 bits with each bit as a mask, not over the set bits
  // alone: every lane of a warp then reads the same constant-memory
  // word at each step (a broadcast) and no lane diverges.  Nothing is
  // hoisted across dims: the 32 per-bit masks would cost 32 registers.
  PT_HD float unit(int d) const {
    uint32_t acc;
    if (d == 0) {
      acc = __brev(h);  // dimension 0 is the identity matrix
    } else {
      acc = 0u;
#pragma unroll
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

// Sample `sample` of lane `lane`: Sobol point idx of pixel pixel_id.
PT_HD SobolNoise sobol_noise(const TraceParams& prm, int pixel_id, uint32_t idx, uint32_t lane,
                             uint32_t sample) {
  SobolNoise s;
  s.h = laine_karras(__brev(idx), lowbias32((uint32_t)pixel_id + prm.sobol_key));
  s.key = prm.sobol_key;
  s.dims = prm.sobol_dims;
  s.tail = PhiloxNoise{prm.seed0, prm.seed1, lane, sample};
  return s;
}

// AA jitter from two uniforms: uniform, normal (Box-Muller) or
// truncated-normal clipped at +/- 3 sigma (ops/trace_pallas.draw_aa_jitter).
PT_HD void aa_jitter(int aa_type, float u1, float u2, float* a1, float* a2) {
  if (aa_type == kAaUniform) {
    *a1 = 2.0f * u1 - 1.0f;
    *a2 = 2.0f * u2 - 1.0f;
    return;
  }
  const float r = sqrtf(-2.0f * logf(u1));
  float z1 = r * cosf(kTwoPi * u2);
  float z2 = r * sinf(kTwoPi * u2);
  if (aa_type == kAaTruncatedNormal) {
    z1 = fminf(fmaxf(z1, -3.0f), 3.0f);
    z2 = fminf(fmaxf(z2, -3.0f), 3.0f);
  }
  *a1 = z1;
  *a2 = z2;
}

// ------------------------------------------------------- intersection ----
PT_HD float sphere_t(float cx, float cy, float cz, float radius, V3 o, V3 d) {
  const float ox = o.x - cx, oy = o.y - cy, oz = o.z - cz;
  const float b = 2.0f * (ox * d.x + oy * d.y + oz * d.z);
  const float c = ox * ox + oy * oy + oz * oz - radius * radius;
  const float disc = b * b - 4.0f * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float near_t = (-b - sq) * 0.5f;
  const float far_t = (-b + sq) * 0.5f;
  const float t = near_t > kEps ? near_t : (far_t > kEps ? far_t : INFINITY);
  return disc >= 0.0f ? t : INFINITY;
}

PT_HD float disc_t(const float* q, V3 o, V3 d) {
  const float nx = q[0], ny = q[1], nz = q[2];
  const float denom = d.x * nx + d.y * ny + d.z * nz;
  const float num = (q[3] - o.x) * nx + (q[4] - o.y) * ny + (q[5] - o.z) * nz;
  const bool ok_denom = fabsf(denom) > 1e-12f;
  const float t = num / (ok_denom ? denom : 1e-12f);
  const float px = o.x + d.x * t - q[3];
  const float py = o.y + d.y * t - q[4];
  const float pz = o.z + d.z * t - q[5];
  const bool inside = px * px + py * py + pz * pz <= q[6] * q[6];
  return (t > kEps && inside && ok_denom) ? t : INFINITY;
}

struct Hit {
  bool valid, emissive;
  int material;
  V3 point, normal, colour, emission;
};

// Nearest hit over the packed tables (spheres, then discs; the last
// strictly-closer object wins, as in core/geometry.intersect_scene).
PT_HD Hit intersect(const float* sph, int num_s, const float* dsc, int num_d, V3 o, V3 d) {
  float best_t = INFINITY;
  const float* win = nullptr;  // attribute block of the winner
  V3 win_c = {0.f, 0.f, 0.f}, nrm = {0.f, 0.f, 0.f};
  bool won_sphere = false;
  for (int k = 0; k < num_s; ++k) {
    const float* q = sph + k * kSphereF;
    const float t = sphere_t(q[0], q[1], q[2], q[3], o, d);
    if (t < best_t) {
      best_t = t;
      win = q + 4;
      win_c = V3{q[0], q[1], q[2]};
      won_sphere = true;
    }
  }
  for (int j = 0; j < num_d; ++j) {
    const float* q = dsc + j * kDiscF;
    const float t = disc_t(q, o, d);
    if (t < best_t) {
      best_t = t;
      win = q + 7;
      nrm = V3{q[0], q[1], q[2]};
      won_sphere = false;
    }
  }
  Hit h;
  h.valid = best_t < INFINITY;
  const float t = h.valid ? best_t : 0.0f;
  h.point = V3{o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
  if (won_sphere) {
    const V3 n = h.point - win_c;
    nrm = n * (1.0f / sqrtf(fmaxf(dot(n, n), 1e-20f)));
  }
  h.normal = nrm;
  if (win) {
    h.colour = V3{win[0], win[1], win[2]};
    h.emission = V3{win[3], win[4], win[5]};
    h.emissive = win[6] > 0.5f;
    h.material = (int)win[7];
  } else {
    h.colour = h.emission = V3{0.f, 0.f, 0.f};
    h.emissive = false;
    h.material = 0;
  }
  return h;
}

// ------------------------------------------------------------- BSDFs ----
PT_HD V3 sample_diffuse(V3 n, float u1, float u2, float* cos_theta) {
  const bool use_x = fabsf(n.x) > fabsf(n.y);
  V3 t1;
  if (use_x) {
    const float inv = 1.0f / sqrtf(fmaxf(n.x * n.x + n.z * n.z, 1e-20f));
    t1 = V3{-n.z * inv, 0.0f, n.x * inv};
  } else {
    const float inv = 1.0f / sqrtf(fmaxf(n.y * n.y + n.z * n.z, 1e-20f));
    t1 = V3{0.0f, n.z * inv, -n.y * inv};
  }
  const V3 t2 = cross(n, t1);
  const float r = sqrtf(fmaxf(1.0f - u1 * u1, 0.0f));
  const float phi = kTwoPi * u2;
  const float sx = cosf(phi) * r, sy = sinf(phi) * r;
  const V3 d = t1 * sx + t2 * sy + n * u1;
  *cos_theta = dot(d, n);
  return d;
}

PT_HD V3 reflect(V3 d, V3 n) { return d - n * (2.0f * dot(d, n)); }

PT_HD V3 refract(V3 d, V3 n, float n_idx, float rand, bool* refracted) {
  float r0 = (1.0f - n_idx) / (1.0f + n_idx);
  r0 = r0 * r0;
  const bool inside = dot(d, n) > 0.0f;
  const V3 nl = inside ? n * -1.0f : n;
  const float eta = inside ? n_idx : 1.0f / n_idx;
  const float cost1 = -dot(d, nl);
  const float cost2 = 1.0f - eta * eta * (1.0f - cost1 * cost1);
  const float p1 = 1.0f - cost1;
  const float p2 = p1 * p1;
  const float rprob = r0 + (1.0f - r0) * (p2 * p2 * p1);
  *refracted = (cost2 > 0.0f) && (rand > rprob);
  if (*refracted) return normalized(d * eta + nl * (eta * cost1 - sqrtf(fmaxf(cost2, 0.0f))));
  return normalized(d + nl * (2.0f * cost1));
}

// ------------------------------------------------------------- trace ----
struct TraceResult {
  V3 radiance, esc_dir, esc_w;
  int escaped, path_len;
};

// The camera ray of one sample: AA jitter and thin lens from noise group 0.
template <class Noise>
PT_HD void ray_begin(const TraceParams& prm, float col, float row, const Noise& noise, V3& o,
                     V3& d) {
  float g[4];
  noise.group(0, g);
  float a1 = g[0], a2 = g[1];
  if (!Noise::kJitterDistributed) aa_jitter(prm.aa_type, g[0], g[1], &a1, &a2);
  const float c = col + prm.aa_scale * a1;
  const float r = row + prm.aa_scale * a2;
  const float w = (float)prm.width, h = (float)prm.height;
  const float dx = ((2.0f * c - w) / w) * prm.tanfov_x;
  const float dy = -((2.0f * r - h) / h) * prm.tanfov_y;
  const float inv = 1.0f / sqrtf(dx * dx + dy * dy + 1.0f);
  d = V3{dx * inv, dy * inv, -inv};
  o = V3{0.0f, 0.0f, 0.0f};
  if (prm.aperture > 0.0f) {  // thin lens; aperture 0 keeps the pinhole ray untouched
    const float lr = prm.aperture * sqrtf(g[2]);
    const float lphi = kTwoPi * g[3];
    const float lx = lr * cosf(lphi), ly = lr * sinf(lphi);
    const float t_f = prm.focal / fmaxf(-d.z, 1e-8f);
    const V3 fd = {d.x * t_f - lx, d.y * t_f - ly, d.z * t_f};
    d = fd * (1.0f / sqrtf(fmaxf(dot(fd, fd), 1e-20f)));
    o = V3{lx, ly, 0.0f};
  }
}

// Bounce b of a live ray (origin o, direction d, throughput tp): false if
// the ray ends here - roulette, escape or emitter, with what it gathers in
// res - and true if it scattered and goes on.
template <class Noise>
PT_HD bool ray_bounce(const TraceParams& prm, const float* sph, const float* dsc,
                      const Noise& noise, int b, V3& o, V3& d, V3& tp, TraceResult& res) {
  float u[4];  // rr, bsdf u1, bsdf u2, fresnel
  noise.group(1 + b, u);
  const bool rr_on = b >= prm.roulette_depth;
  if (rr_on && u[0] <= prm.stop_prob) return false;  // roulette kill
  const float rr_weight = 1.0f / (1.0f - prm.stop_prob);
  const float rr_factor = rr_on ? rr_weight : 1.0f;
  const Hit hit = intersect(sph, prm.num_s, dsc, prm.num_d, o, d);
  res.path_len += 1;  // escape, emission and scatter each push once
  if (!hit.valid) {
    res.esc_dir = d;
    res.esc_w = tp * rr_factor;
    res.escaped = 1;
    return false;
  }
  if (hit.emissive) {
    res.radiance = res.radiance + cwise(tp, hit.emission) * rr_factor;
    return false;
  }
  V3 scale;
  if (hit.material == 0) {
    float cos_theta;
    d = sample_diffuse(hit.normal, u[1], u[2], &cos_theta);
    scale = hit.colour * (cos_theta * kDiffuseScale * rr_factor);
  } else if (hit.material == 1) {
    d = reflect(d, hit.normal);
    scale = V3{rr_factor, rr_factor, rr_factor};
  } else {
    bool refracted;
    d = refract(d, hit.normal, prm.refr_index, u[3], &refracted);
    const V3 tint = refracted ? hit.colour : V3{1.0f, 1.0f, 1.0f};
    scale = tint * (kRefractWeight * rr_factor);
  }
  tp = cwise(tp, scale);
  o = hit.point;
  return true;
}

PT_HD TraceResult no_result() {
  TraceResult res;
  res.radiance = res.esc_dir = res.esc_w = V3{0.f, 0.f, 0.f};
  res.escaped = 0;
  res.path_len = 0;
  return res;
}

// One sample of one ray: raygen with AA jitter and thin lens, then the
// bounce loop until the ray escapes, hits an emitter, is absorbed by
// roulette, or reaches max_path_length.  (K1 runs the same two steps,
// ray_begin and ray_bounce, with its lanes refilled between bounces:
// trace.cu.)
//
// kStubBounce is the megastep's measurement stub of the bounce
// (ops/megastep_pallas.py::_stub_bounce): raygen runs and every bounce
// draws its four uniforms, but a bounce only adds (rr < 2) to the path
// length and the ray never dies, so no bounce is skipped; radiance and
// the escape stay zero.  The raygen direction and the other three
// uniforms enter the comparison times zero, which nvcc cannot fold
// without fast-math, so none of that work is deleted.
//
// kCount (K3's recording kernel) also writes to *iters the bounce
// iterations the ray ran: a ray that ends at bounce b, by the roulette
// or otherwise, ran b + 1.
template <bool kStubBounce = false, bool kCount = false, class Noise>
PT_HD TraceResult trace_ray(const TraceParams& prm, const float* sph, const float* dsc,
                           float col, float row, const Noise& noise, int* iters = nullptr) {
  V3 o, d;
  ray_begin(prm, col, row, noise, o, d);
  TraceResult res = no_result();
  if constexpr (kStubBounce) {
    const float keep = (d.x + d.y + d.z + o.x + o.y) * 0.0f;
    for (int b = 0; b < prm.max_path_length; ++b) {
      float u[4];  // rr, bsdf u1, bsdf u2, fresnel
      noise.group(1 + b, u);
      res.path_len += u[0] + ((u[1] + u[2] + u[3]) * 0.0f + keep) < 2.0f;
    }
    return res;
  }
  V3 tp = {1.0f, 1.0f, 1.0f};
  if constexpr (kCount) {
    int b = 0;
    while (b < prm.max_path_length && ray_bounce(prm, sph, dsc, noise, b++, o, d, tp, res)) {
    }
    *iters = b;
    return res;
  }
  for (int b = 0; b < prm.max_path_length; ++b)
    if (!ray_bounce(prm, sph, dsc, noise, b, o, d, tp, res)) break;
  return res;
}

// Copy the packed scene tables into shared memory (all threads help).
PT_HD void load_tables(const TraceParams& prm, const float* sph_g, const float* dsc_g,
                       float* s_tables) {
  const int ns = prm.num_s * kSphereF, nd = prm.num_d * kDiscF;
  for (int i = threadIdx.x; i < ns + nd; i += blockDim.x)
    s_tables[i] = i < ns ? sph_g[i] : dsc_g[i - ns];
}

inline size_t tables_bytes(const TraceParams& prm) {
  return (size_t)(prm.num_s * kSphereF + prm.num_d * kDiscF) * sizeof(float);
}

}  // namespace pt
