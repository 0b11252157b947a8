// Native baseline JPEG scan of the preview stream (ui/jpeg.py).
//
// The entropy-coded scan of a 4:2:0 JFIF image: edge-replicated padding
// to 16x16 MCUs, RGB -> YCbCr with the IJG fixed-point tables, 2x2 chroma
// means with the alternating bias 1, 2, the IJG integer DCT (jfdctint),
// rounding quantisation and Huffman coding in MCU order, with 0xFF
// stuffing and a one-padded last byte.  Every step is integer
// arithmetic, so the bytes equal ui/jpeg.py::encode_scan_plain's.  The
// quantisation and Huffman tables come from the caller (ui/jpeg.py
// builds them and writes the markers around the scan).
//
// The MCUs' coefficients are computed in parallel (OpenMP), the Huffman
// coding runs serially.  Exposed with a C ABI for ctypes; built into the
// same library as pt_host.cpp (runtime/native.py).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr std::int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270;
constexpr std::int32_t F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137;
constexpr std::int32_t F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr std::int64_t fix16(double x) { return static_cast<std::int64_t>(x * 65536 + 0.5); }

inline std::int32_t descale(std::int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// One pass of jfdctint over 8 values d[0], d[s], ..., d[7 s].  Its
// products and sums stay within 32 bits for 8-bit samples (as in the IJG
// code, which keeps them in INT32).
void fdct_1d(std::int32_t* d, int s, bool last) {
  const std::int32_t t0 = d[0] + d[7 * s], t7 = d[0] - d[7 * s];
  const std::int32_t t1 = d[s] + d[6 * s], t6 = d[s] - d[6 * s];
  const std::int32_t t2 = d[2 * s] + d[5 * s], t5 = d[2 * s] - d[5 * s];
  const std::int32_t t3 = d[3 * s] + d[4 * s], t4 = d[3 * s] - d[4 * s];
  const std::int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
  const int sh = last ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
  if (last) {
    d[0] = descale(t10 + t11, kPass1Bits);
    d[4 * s] = descale(t10 - t11, kPass1Bits);
  } else {
    d[0] = (t10 + t11) * (1 << kPass1Bits);
    d[4 * s] = (t10 - t11) * (1 << kPass1Bits);
  }
  std::int32_t z1 = (t12 + t13) * F0541;
  d[2 * s] = descale(z1 + t13 * F0765, sh);
  d[6 * s] = descale(z1 + t12 * -F1847, sh);
  z1 = t4 + t7;
  std::int32_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
  const std::int32_t z5 = (z3 + z4) * F1175;
  const std::int32_t m4 = t4 * F0298, m5 = t5 * F2053, m6 = t6 * F3072, m7 = t7 * F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  d[7 * s] = descale(m4 + z1 + z3, sh);
  d[5 * s] = descale(m5 + z2 + z4, sh);
  d[3 * s] = descale(m6 + z2 + z3, sh);
  d[s] = descale(m7 + z1 + z4, sh);
}

// floor(x / d) for 0 <= x < 2^32 as (x * mul) >> shift: mul =
// ceil(2^(32 + l) / d) with 2^(l - 1) < d <= 2^l is exact on that range
// (Granlund and Montgomery), and spares a division per coefficient.
struct Divisor {
  std::uint64_t half, mul;
  int shift;
};

Divisor make_divisor(std::uint32_t d) {
  int l = 0;
  while ((std::uint64_t{1} << l) < d) ++l;
  const int shift = 32 + l;
  return {d >> 1, ((std::uint64_t{1} << shift) + d - 1) / d, shift};
}

// Level-shifted samples (8x8, row-major) -> quantised coefficients in
// zigzag order: |x| / (8 q) rounded half up, the sign kept.
void dct_quantise(std::int32_t* blk, const Divisor* q, std::int16_t* out) {
  for (int r = 0; r < 8; ++r) fdct_1d(blk + 8 * r, 1, false);
  for (int c = 0; c < 8; ++c) fdct_1d(blk + c, 8, true);
  for (int k = 0; k < 64; ++k) {
    const int n = kZigzag[k];
    const std::int32_t c = blk[n];
    const std::uint64_t a = static_cast<std::uint64_t>(c < 0 ? -c : c) + q[n].half;
    const std::int64_t mag = static_cast<std::int64_t>((a * q[n].mul) >> q[n].shift);
    out[k] = static_cast<std::int16_t>(c < 0 ? -mag : mag);
  }
}

struct BitWriter {
  std::uint8_t* out;
  std::int64_t cap, len = 0;
  std::uint64_t acc = 0;
  int n = 0;
  bool overflow = false;

  void put(std::uint32_t code, int size) {
    acc = (acc << size) | code;
    n += size;
    while (n >= 8) {
      n -= 8;
      const std::uint8_t byte = static_cast<std::uint8_t>((acc >> n) & 0xFF);
      emit(byte);
      if (byte == 0xFF) emit(0);
    }
    acc &= (std::uint64_t{1} << n) - 1;
  }
  void emit(std::uint8_t b) {
    if (len < cap) out[len] = b; else overflow = true;
    ++len;
  }
  void flush() {
    if (n) put((1u << (8 - n)) - 1, 8 - n);
  }
};

// The bit count of |v| (0 for 0): the JPEG magnitude category.
int category(std::int32_t v) {
  const std::uint32_t a = static_cast<std::uint32_t>(v < 0 ? -v : v);
  return a ? 32 - __builtin_clz(a) : 0;
}

}  // namespace

extern "C" {

// rgb: (height, width, 3) uint8.  qt: (2, 64) luma/chroma quantisers in
// natural order.  codes/sizes: (4, 256) Huffman codes and lengths of the
// DC luma, AC luma, DC chroma and AC chroma tables.  Writes the scan to
// out and returns its length, or -1 if it needs more than cap bytes.
std::int64_t pt_jpeg_scan(const std::uint8_t* rgb, std::int32_t width, std::int32_t height,
                          const std::int32_t* qt, const std::uint32_t* codes,
                          const std::uint8_t* sizes, std::uint8_t* out, std::int64_t cap) {
  const std::int32_t mcux = (width + 15) / 16, mcuy = (height + 15) / 16;
  const std::int64_t mcus = static_cast<std::int64_t>(mcux) * mcuy;
  std::vector<std::int16_t> coef(static_cast<std::size_t>(mcus) * 6 * 64);
  const std::int64_t half = 1 << 15, off = (std::int64_t{128} << 16) + half - 1;
  const std::int64_t yr = fix16(0.299), yg = fix16(0.587), yb = fix16(0.114);
  const std::int64_t cbr = fix16(0.16874), cbg = fix16(0.33126), c5 = fix16(0.5);
  const std::int64_t crg = fix16(0.41869), crb = fix16(0.08131);
  Divisor div[128];
  for (int i = 0; i < 128; ++i) div[i] = make_divisor(static_cast<std::uint32_t>(qt[i]) << 3);

#pragma omp parallel for schedule(static)
  for (std::int64_t m = 0; m < mcus; ++m) {
    const std::int32_t my = static_cast<std::int32_t>(m / mcux);
    const std::int32_t mx = static_cast<std::int32_t>(m % mcux);
    std::int64_t y[16][16], cb[16][16], cr[16][16];
    for (int i = 0; i < 16; ++i) {
      const std::int32_t py = std::min(my * 16 + i, height - 1);
      for (int j = 0; j < 16; ++j) {
        const std::int32_t px = std::min(mx * 16 + j, width - 1);
        const std::uint8_t* p = rgb + 3 * (static_cast<std::int64_t>(py) * width + px);
        const std::int64_t r = p[0], g = p[1], b = p[2];
        y[i][j] = (yr * r + yg * g + yb * b + half) >> 16;
        cb[i][j] = (-cbr * r - cbg * g + c5 * b + off) >> 16;
        cr[i][j] = (c5 * r - crg * g - crb * b + off) >> 16;
      }
    }
    std::int16_t* dst = coef.data() + m * 6 * 64;
    std::int32_t blk[64];
    for (int b = 0; b < 4; ++b) {
      const int oy = 8 * (b >> 1), ox = 8 * (b & 1);
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j)
          blk[8 * i + j] = static_cast<std::int32_t>(y[oy + i][ox + j] - 128);
      dct_quantise(blk, div, dst + b * 64);
    }
    for (int c = 0; c < 2; ++c) {
      const std::int64_t(*plane)[16] = c ? cr : cb;
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) {
          const std::int64_t bias = (j & 1) ? 2 : 1;
          blk[8 * i + j] = static_cast<std::int32_t>(
              ((plane[2 * i][2 * j] + plane[2 * i][2 * j + 1] + plane[2 * i + 1][2 * j] +
                plane[2 * i + 1][2 * j + 1] + bias) >> 2) - 128);
        }
      dct_quantise(blk, div + 64, dst + (4 + c) * 64);
    }
  }

  BitWriter bw{out, cap};
  std::int32_t pred[3] = {0, 0, 0};
  for (std::int64_t m = 0; m < mcus; ++m) {
    for (int b = 0; b < 6; ++b) {
      const std::int16_t* zz = coef.data() + (m * 6 + b) * 64;
      const int comp = b < 4 ? 0 : b - 3;
      const int dc_t = comp ? 2 : 0, ac_t = dc_t + 1;
      const std::uint32_t* dcc = codes + 256 * dc_t;
      const std::uint8_t* dcs = sizes + 256 * dc_t;
      const std::uint32_t* acc = codes + 256 * ac_t;
      const std::uint8_t* acs = sizes + 256 * ac_t;
      const std::int32_t diff = zz[0] - pred[comp];
      pred[comp] = zz[0];
      int s = category(diff);
      bw.put(dcc[s], dcs[s]);
      if (s) bw.put(static_cast<std::uint32_t>(diff > 0 ? diff : diff + (1 << s) - 1), s);
      int run = 0;
      for (int k = 1; k < 64; ++k) {
        const std::int32_t v = zz[k];
        if (v == 0) {
          ++run;
          continue;
        }
        while (run > 15) {
          bw.put(acc[0xF0], acs[0xF0]);
          run -= 16;
        }
        s = category(v);
        const int sym = (run << 4) | s;
        bw.put(acc[sym], acs[sym]);
        bw.put(static_cast<std::uint32_t>(v > 0 ? v : v + (1 << s) - 1), s);
        run = 0;
      }
      if (run) bw.put(acc[0], acs[0]);
    }
  }
  bw.flush();
  return bw.overflow ? -1 : bw.len;
}

}  // extern "C"
