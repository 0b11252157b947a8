// Native host runtime of the port: the film, tone map, clear and
// load-balancer loops, in C++ with OpenMP.
//
// The port's own copy of the JAX package's csrc/pt_host.cpp, with the
// same five entry points.  Two differences: it is built with
// -ffp-contract=off (runtime/native.py), so that `r * scale` rounds on
// its own as NumPy rounds it and the film equals its plain version bit
// for bit; and the load balancer sorts stably, so that records of equal
// path length keep their order and the deal equals its NumPy replay
// (runtime/worklist.py) on any input.
//
// The record layout is the reference's 20-byte TraceRecord
// (core/records.py TRACE_RECORD_DTYPE).  Exposed with a C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

#pragma pack(push, 1)
struct TraceRecord {
  std::uint16_t u, v;
  float r, g, b;
  std::uint16_t sampleCount;
  std::uint16_t pathLength;
};
#pragma pack(pop)

static_assert(sizeof(TraceRecord) == 20, "TraceRecord must be 20 bytes");

}  // namespace

extern "C" {

// hdr is row-major (height, width, 3) float32 RGB.  Padding records
// (coords outside the image) and empty ones are skipped; each record adds
// rgb / sampleCount.  No atomics: a worklist holds one record per pixel
// (the load balancer permutes records and never duplicates them).
void pt_accumulate(const std::uint8_t* recordBytes, std::int64_t numRecords,
                   float* hdr, std::int32_t width, std::int32_t height) {
  const TraceRecord* recs = reinterpret_cast<const TraceRecord*>(recordBytes);
#pragma omp parallel for schedule(static)
  for (std::int64_t i = 0; i < numRecords; ++i) {
    const TraceRecord& t = recs[i];
    if (t.u >= width || t.v >= height || t.sampleCount == 0) continue;
    const float scale = 1.0f / t.sampleCount;
    float* px = hdr + 3 * (static_cast<std::int64_t>(t.v) * width + t.u);
    px[0] += t.r * scale;
    px[1] += t.g * scale;
    px[2] += t.b * scale;
  }
}

// pt_accumulate from SoA arrays with int32 counts (the device film's
// fetch: its counts outgrow the wire record's u16).  The (u, v) pairs
// must be unique across records, as above.
void pt_accumulate_soa(const std::int32_t* u, const std::int32_t* v,
                       const float* r, const float* g, const float* b,
                       const std::int32_t* sampleCount,
                       std::int64_t numRecords, float* hdr,
                       std::int32_t width, std::int32_t height) {
#pragma omp parallel for schedule(static)
  for (std::int64_t i = 0; i < numRecords; ++i) {
    const std::int32_t ui = u[i], vi = v[i], c = sampleCount[i];
    if (ui < 0 || ui >= width || vi < 0 || vi >= height || c <= 0) continue;
    const float scale = 1.0f / static_cast<float>(c);
    float* px = hdr + 3 * (static_cast<std::int64_t>(vi) * width + ui);
    px[0] += r[i] * scale;
    px[1] += g[i] * scale;
    px[2] += b[i] * scale;
  }
}

// out = clamp(pow(in * 2^exposure, 1/gamma) * 255 + 0.5, 0, 255): rounds
// half up, as the reference's cv::convertTo does.
void pt_tonemap(const float* hdr, std::uint8_t* out, std::int64_t n,
                float exposure, float gamma) {
  const float exposureScale = std::pow(2.0f, exposure);
  const float invGamma = 1.0f / gamma;
#pragma omp parallel for schedule(static)
  for (std::int64_t i = 0; i < n; ++i) {
    float x = hdr[i] * exposureScale;
    x = x > 0.0f ? std::pow(x, invGamma) : 0.0f;
    x = x * 255.0f + 0.5f;
    out[i] = static_cast<std::uint8_t>(x < 0.f ? 0.f : (x > 255.f ? 255.f : x));
  }
}

// Zero rgb, sampleCount and pathLength and return the pathLength sum
// (the Rays/sec statistic), in one pass.
std::uint64_t pt_clear_and_sum_pathlengths(std::uint8_t* recordBytes,
                                           std::int64_t numRecords) {
  TraceRecord* recs = reinterpret_cast<TraceRecord*>(recordBytes);
  std::uint64_t sum = 0;
#pragma omp parallel for reduction(+ : sum) schedule(static)
  for (std::int64_t i = 0; i < numRecords; ++i) {
    TraceRecord& t = recs[i];
    sum += t.pathLength;
    t.r = t.g = t.b = 0.f;
    t.sampleCount = 0;
    t.pathLength = 0;
  }
  return sum;
}

// Sort a copy stably by pathLength, then deal (shortest, longest) pairs
// to each tile in turn and flatten back in tile order; an odd middle
// record ends tile 0's run.  The reference's allocateWorkByPathLength.
void pt_load_balance(std::uint8_t* recordBytes, std::int64_t numRecords,
                     std::int64_t numTiles) {
  TraceRecord* recs = reinterpret_cast<TraceRecord*>(recordBytes);
  std::vector<TraceRecord> sorted(recs, recs + numRecords);
  std::stable_sort(sorted.begin(), sorted.end(),
                   [](const TraceRecord& a, const TraceRecord& b) {
                     return a.pathLength < b.pathLength;
                   });
  if (numTiles <= 0) numTiles = 1;
  std::vector<std::vector<TraceRecord>> tileWork(numTiles);
  for (auto& t : tileWork) t.reserve(numRecords / numTiles + 2);
  std::int64_t lo = 0, hi = numRecords - 1;
  while (lo < hi) {
    for (std::int64_t t = 0; t < numTiles && lo < hi; ++t) {
      tileWork[t].push_back(sorted[lo++]);
      tileWork[t].push_back(sorted[hi--]);
    }
  }
  if (lo == hi) tileWork[0].push_back(sorted[lo]);
  std::int64_t i = 0;
  for (auto& t : tileWork)
    for (auto& w : t) recs[i++] = w;
}

}  // extern "C"
