"""Baseline JPEG (JFIF) encoder and decoder for the preview stream.

The JAX package encodes and decodes its previews with PIL, which the
GPU host does not have; the port carries its own coder instead.

Encoder: baseline sequential JFIF, 4:2:0 chroma, the Annex K
quantisation tables scaled by the IJG quality formula (quality 85, PIL's
setting in the JAX package), the Annex K Huffman tables.  Every pixel
step is integer arithmetic, so it is exact on any machine:

- the image is padded to whole 16x16 MCUs by replicating its last
  column and row;
- RGB -> YCbCr with the IJG fixed-point tables (16 fraction bits; Cb and
  Cr rounded with 0.5 - epsilon), 2x2 chroma means with the alternating
  bias 1, 2;
- the IJG integer DCT (``jfdctint``, 13 constant bits, 2 pass bits),
  quantised by rounding |x| / (8 q) half up;
- Huffman coding of the DC differences and AC run lengths in MCU order
  (four Y blocks, Cb, Cr), 0xFF bytes stuffed, the last byte padded
  with ones.

Two versions compute the entropy-coded scan: ``encode_scan_plain`` in
NumPy (the reference the tests hold the native one to) and the C++ one
in the port's host library (``csrc/pt_jpeg.cpp``, runtime/native.py),
byte for byte the same.  ``encode`` (what the server calls) runs the
native one; a failed build raises, nothing falls back to NumPy.  Python
writes the markers around the scan for both, from the same tables.

Decoder (NumPy, for the client): baseline Huffman JPEG with 1 or 3
components, any 1x/2x sampling, restart intervals; the IJG integer
inverse DCT (``jidctint``), libjpeg's "fancy" triangle upsampling for
2x2 chroma and its fixed-point YCbCr -> RGB, so it reproduces libjpeg's
default decode of such files.
"""

from __future__ import annotations

import re
import struct

import numpy as np

QUALITY = 85

# Annex K.1 / K.2 quantisation tables, natural (row-major) order.
_BASE_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_BASE_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    *([99] * 32)], np.int64)

# Natural index of the k-th coefficient in zigzag order.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# Annex K.3 Huffman tables: (code counts per length 1..16, symbols).
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
    0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3,
    0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
    0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
    0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18,
    0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA,
    0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7,
    0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA))
# The encoder's tables in the order of the native entry point's arrays.
HUFFMAN_TABLES = (_DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA)

# The IJG integer DCT's constants (13 fraction bits).
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _fix(x: float) -> int:
    """The IJG fixed point with 16 fraction bits."""
    return int(x * 65536 + 0.5)


def quant_tables(quality: int = QUALITY) -> np.ndarray:
    """(2, 64) luma and chroma tables in natural order, scaled by the IJG
    quality formula and clamped to [1, 255] (baseline)."""
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality} is not in [1, 100]")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    base = np.stack([_BASE_LUMA, _BASE_CHROMA])
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def huffman_codes(counts, symbols) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) of each symbol (256 entries; 0 length = unused),
    assigned canonically as Annex C does."""
    code_of = np.zeros(256, np.uint32)
    size_of = np.zeros(256, np.uint8)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            size_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, size_of


def coder_tables() -> tuple[np.ndarray, np.ndarray]:
    """(4, 256) codes and lengths: DC luma, AC luma, DC chroma, AC chroma."""
    pairs = [huffman_codes(*t) for t in HUFFMAN_TABLES]
    return np.stack([c for c, _ in pairs]), np.stack([s for _, s in pairs])


# --- the encoder's pixel pipeline (NumPy) ---------------------------------------------------


def _ycbcr(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (3, H, W) int64 Y, Cb, Cr (the IJG tables)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    off = (128 << 16) + half - 1
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off) >> 16
    return np.stack([y, cb, cr])


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d: list, last: bool) -> list:
    """One pass of the IJG integer DCT along the 8 arrays of ``d``."""
    t0, t7 = d[0] + d[7], d[0] - d[7]
    t1, t6 = d[1] + d[6], d[1] - d[6]
    t2, t5 = d[2] + d[5], d[2] - d[5]
    t3, t4 = d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    sh = _CONST_BITS + _PASS1_BITS if last else _CONST_BITS - _PASS1_BITS
    out = [None] * 8
    if last:
        out[0] = _descale(t10 + t11, _PASS1_BITS)
        out[4] = _descale(t10 - t11, _PASS1_BITS)
    else:
        out[0] = (t10 + t11) << _PASS1_BITS
        out[4] = (t10 - t11) << _PASS1_BITS
    z1 = (t12 + t13) * _F0541
    out[2] = _descale(z1 + t13 * _F0765, sh)
    out[6] = _descale(z1 + t12 * -_F1847, sh)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _F1175
    t4, t5, t6, t7 = t4 * _F0298, t5 * _F2053, t6 * _F3072, t7 * _F1501
    z1, z2, z3, z4 = z1 * -_F0899, z2 * -_F2562, z3 * -_F1961, z4 * -_F0390
    z3 = z3 + z5
    z4 = z4 + z5
    out[7] = _descale(t4 + z1 + z3, sh)
    out[5] = _descale(t5 + z2 + z4, sh)
    out[3] = _descale(t6 + z2 + z3, sh)
    out[1] = _descale(t7 + z1 + z4, sh)
    return out


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) level-shifted samples -> (N, 8, 8) DCT x 8 (jfdctint)."""
    rows = _fdct_1d([blocks[:, :, i] for i in range(8)], last=False)
    rows = np.stack(rows, axis=2)
    cols = _fdct_1d([rows[:, i, :] for i in range(8)], last=True)
    return np.stack(cols, axis=1)


def _quantise(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Round |coef| / (8 q) half up, keeping the sign."""
    div = (q << 3).reshape(8, 8)
    mag = (np.abs(coef) + (div >> 1)) // div
    return np.where(coef < 0, -mag, mag)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def quantised_blocks(rgb: np.ndarray, qt: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The quantised DCT blocks of Y (Hm*2, Wm*2, 64) and of Cb, Cr
    (Hm, Wm, 64) each, natural order, for Hm x Wm MCUs of 16x16."""
    h, w = rgb.shape[:2]
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    padded = np.pad(rgb, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    ycc = _ycbcr(padded)
    bias = np.tile(np.array([1, 2], np.int64), wp // 4)
    chroma = [(c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2] + bias) >> 2
              for c in ycc[1:]]
    out = []
    for plane, q in ((ycc[0], qt[0]), (chroma[0], qt[1]), (chroma[1], qt[1])):
        b = _blocks(plane - 128)
        shape = b.shape[:2]
        coef = _quantise(_fdct(b.reshape(-1, 8, 8)), q)
        out.append(coef.reshape(*shape, 64))
    return tuple(out)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, size: int) -> None:
        self.acc = (self.acc << size) | code
        self.n += size
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def encode_scan_plain(rgb: np.ndarray, quality: int = QUALITY) -> bytes:
    """The entropy-coded scan of ``rgb`` (H, W, 3) uint8, NumPy and Python:
    the reference of the native coder."""
    rgb = _check_rgb(rgb)
    encode_scan_plain.calls += 1
    y, cb, cr = quantised_blocks(rgb, quant_tables(quality))
    codes, sizes = coder_tables()
    bw = _BitWriter()
    pred = [0, 0, 0]

    def block(coef: np.ndarray, comp: int, dc_t: int, ac_t: int) -> None:
        zz = coef[ZIGZAG]
        diff = int(zz[0]) - pred[comp]
        pred[comp] = int(zz[0])
        s = _category(diff)
        bw.put(int(codes[dc_t, s]), int(sizes[dc_t, s]))
        if s:
            bw.put(diff if diff > 0 else diff + (1 << s) - 1, s)
        run = 0
        for k in range(1, 64):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bw.put(int(codes[ac_t, 0xF0]), int(sizes[ac_t, 0xF0]))
                run -= 16
            s = _category(v)
            sym = (run << 4) | s
            bw.put(int(codes[ac_t, sym]), int(sizes[ac_t, sym]))
            bw.put(v if v > 0 else v + (1 << s) - 1, s)
            run = 0
        if run:
            bw.put(int(codes[ac_t, 0]), int(sizes[ac_t, 0]))

    for my in range(cb.shape[0]):
        for mx in range(cb.shape[1]):
            for dy in (0, 1):
                for dx in (0, 1):
                    block(y[2 * my + dy, 2 * mx + dx], 0, 0, 1)
            block(cb[my, mx], 1, 2, 3)
            block(cr[my, mx], 2, 2, 3)
    return bw.flush()


encode_scan_plain.calls = 0


def _check_rgb(rgb) -> np.ndarray:
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"JPEG encode needs (H, W, 3) uint8, got {rgb.dtype} {rgb.shape}")
    if not (1 <= rgb.shape[0] <= 0xFFFF and 1 <= rgb.shape[1] <= 0xFFFF):
        raise ValueError(f"JPEG encode: size {rgb.shape[1]}x{rgb.shape[0]} out of range")
    return rgb


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(payload) + 2) + payload


def headers(width: int, height: int, quality: int = QUALITY) -> bytes:
    """SOI, JFIF APP0, DQT, SOF0 (4:2:0), DHT and SOS of the encoder."""
    qt = quant_tables(quality)
    dqt = b"".join(bytes([i]) + bytes(qt[i][ZIGZAG].astype(np.uint8)) for i in (0, 1))
    sof = struct.pack(">BHHB", 8, height, width, 3) + bytes([1, 0x22, 0, 2, 0x11, 1,
                                                             3, 0x11, 1])
    dht = b"".join(bytes([cls_id]) + bytes(counts) + bytes(symbols) for cls_id, (counts, symbols)
                   in zip((0x00, 0x10, 0x01, 0x11), HUFFMAN_TABLES))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + _segment(0xDB, dqt) + _segment(0xC0, sof) + _segment(0xC4, dht)
            + _segment(0xDA, sos))


def encode_plain(rgb: np.ndarray, quality: int = QUALITY) -> bytes:
    """A JFIF file of ``rgb`` (H, W, 3) uint8, the NumPy version."""
    rgb = _check_rgb(rgb)
    return headers(rgb.shape[1], rgb.shape[0], quality) + encode_scan_plain(rgb, quality) \
        + b"\xff\xd9"


def encode(rgb: np.ndarray, quality: int = QUALITY) -> bytes:
    """A JFIF file of ``rgb`` (H, W, 3) uint8 through the native coder."""
    from ..runtime import native

    rgb = _check_rgb(rgb)
    return headers(rgb.shape[1], rgb.shape[0], quality) + native.jpeg_scan(
        rgb, quant_tables(quality), *coder_tables()) + b"\xff\xd9"


# --- decoder (NumPy) ---------------------------------------------------------------------


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.n = 0

    def _fill(self) -> None:
        while self.n <= 24:
            b = 0
            if self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFFFFFF
            self.n += 8

    def bits(self, k: int) -> int:
        if k == 0:
            return 0
        if self.n < k:
            self._fill()
        self.n -= k
        return (self.acc >> self.n) & ((1 << k) - 1)

    def peek16(self) -> int:
        if self.n < 16:
            self._fill()
        return (self.acc >> (self.n - 16)) & 0xFFFF

    def skip(self, k: int) -> None:
        self.n -= k


def _decode_table(counts, symbols) -> tuple[np.ndarray, np.ndarray]:
    """A 16-bit lookup: code prefix -> (symbol, length)."""
    sym = np.zeros(1 << 16, np.int32)
    size = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            sym[lo:hi] = symbols[k]
            size[lo:hi] = length
            code += 1
            k += 1
        code <<= 1
    return sym, size


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _unstuff(data: bytes) -> list[bytes]:
    """Entropy-coded data -> its restart intervals, stuffing removed."""
    return [p.replace(b"\xff\x00", b"\xff") for p in re.split(rb"\xff[\xd0-\xd7]", data)]


def _idct_1d(d: list, last: bool) -> list:
    """One pass of the IJG integer inverse DCT (jidctint)."""
    z1 = (d[2] + d[6]) * _F0541
    t2 = z1 + d[6] * -_F1847
    t3 = z1 + d[2] * _F0765
    t0 = (d[0] + d[4]) << _CONST_BITS
    t1 = (d[0] - d[4]) << _CONST_BITS
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0, o1, o2, o3 = o0 * _F0298, o1 * _F2053, o2 * _F3072, o3 * _F1501
    z1, z2, z3, z4 = z1 * -_F0899, z2 * -_F2562, z3 * -_F1961, z4 * -_F0390
    z3 = z3 + z5
    z4 = z4 + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4
    sh = _CONST_BITS + _PASS1_BITS + 3 if last else _CONST_BITS - _PASS1_BITS
    return [_descale(x, sh) for x in (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                                      t13 - o0, t12 - o1, t11 - o2, t10 - o3)]


def _idct_range_limit() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by x & 1023."""
    t = np.zeros(1024, np.int64)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


def _idct(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised coefficients -> (N, 8, 8) samples 0..255."""
    cols = _idct_1d([coef[:, i, :] for i in range(8)], last=False)
    ws = np.stack(cols, axis=1)
    rows = _idct_1d([ws[:, :, i] for i in range(8)], last=True)
    return _idct_range_limit()[np.stack(rows, axis=2) & 1023]


def _fancy_h2v2(c: np.ndarray) -> np.ndarray:
    """libjpeg's h2v2 triangle upsampling of (h, w) -> (2h, 2w)."""
    c = c.astype(np.int64)
    up = np.concatenate([c[:1], c[:-1]])
    down = np.concatenate([c[1:], c[-1:]])
    out = np.empty((2 * c.shape[0], 2 * c.shape[1]), np.int64)
    for r, near in ((0, up), (1, down)):
        s = 3 * c + near
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * s + left + 8) >> 4
        out[r::2, 1::2] = (3 * s + right + 7) >> 4
    return out


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    x_cb = cb.astype(np.int64) - 128
    x_cr = cr.astype(np.int64) - 128
    half = 1 << 15
    r = y + ((_fix(1.402) * x_cr + half) >> 16)
    g = y + ((-_fix(0.34414) * x_cb + half - _fix(0.71414) * x_cr) >> 16)
    b = y + ((_fix(1.772) * x_cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """A baseline JPEG -> (H, W, 3) uint8 RGB (NumPy)."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI marker)")
    qts: dict[int, np.ndarray] = {}
    hts: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    frame = None
    restart = 0
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7 or marker == 0xFF:
            pos -= 1 if marker == 0xFF else 0
            continue
        (length,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                prec, tid = seg[i] >> 4, seg[i] & 15
                n = 128 if prec else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if prec else np.uint8)
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals.astype(np.int64)
                qts[tid] = q
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                cls_id = seg[i]
                counts = tuple(seg[i + 1:i + 17])
                n = sum(counts)
                symbols = tuple(seg[i + 17:i + 17 + n])
                hts[(cls_id >> 4, cls_id & 15)] = _decode_table(counts, symbols)
                i += 17 + n
        elif marker in (0xC0, 0xC1):
            _, height, width, nc = struct.unpack_from(">BHHB", seg, 0)
            comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(nc)]
            frame = (width, height, comps)
        elif marker == 0xDD:
            (restart,) = struct.unpack_from(">H", seg, 0)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: scan before frame header")
            ns = seg[0]
            scan = [(seg[1 + 2 * k], seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15) for k in range(ns)]
            end = pos
            while True:  # the scan ends at the first marker but RSTn
                end = data.find(b"\xff", end)
                if end < 0 or end + 1 >= len(data):
                    end = len(data)
                    break
                if data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
                    end += 2
                    continue
                break
            return _decode_scan(data[pos:end], frame, scan, qts, hts, restart)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"JPEG: only baseline is supported (SOF marker 0x{marker:02X})")
    raise ValueError("JPEG: no scan found")


def _decode_scan(data, frame, scan, qts, hts, restart) -> np.ndarray:
    width, height, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    coefs = [np.zeros((mcuy * c[2], mcux * c[1], 64), np.int64) for c in comps]
    tables = {cid: (hts[(0, td)], hts[(1, ta)]) for cid, td, ta in scan}
    order = [next(k for k, c in enumerate(comps) if c[0] == cid) for cid, _, _ in scan]
    parts = _unstuff(data)
    part_i = 0
    br = _BitReader(parts[0])
    pred = [0] * len(comps)
    zz = ZIGZAG
    for m in range(mcux * mcuy):
        if restart and m and m % restart == 0:
            part_i += 1
            br = _BitReader(parts[part_i])
            pred = [0] * len(comps)
        my, mx = divmod(m, mcux)
        for k in order:
            cid, h, v, _ = comps[k]
            (dsym, dsize), (asym, asize) = tables[cid]
            for by in range(v):
                for bx in range(h):
                    blk = coefs[k][my * v + by, mx * h + bx]
                    p = br.peek16()
                    s = int(dsym[p])
                    br.skip(int(dsize[p]))
                    pred[k] += _extend(br.bits(s), s)
                    blk[0] = pred[k]
                    i = 1
                    while i < 64:
                        p = br.peek16()
                        rs = int(asym[p])
                        br.skip(int(asize[p]))
                        r, s = rs >> 4, rs & 15
                        if s == 0:
                            if r != 15:
                                break
                            i += 16
                            continue
                        i += r
                        blk[zz[i]] = _extend(br.bits(s), s)
                        i += 1
    planes = []
    for k, (cid, h, v, tq) in enumerate(comps):
        c = coefs[k]
        by, bx = c.shape[:2]
        px = _idct((c * qts[tq]).reshape(-1, 8, 8)).reshape(by, bx, 8, 8)
        plane = px.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        cw, ch = -(-width * h // hmax), -(-height * v // vmax)
        plane = plane[:ch, :cw]
        if (hmax // h, vmax // v) == (2, 2):
            plane = _fancy_h2v2(plane)
        elif (h, v) != (hmax, vmax):
            plane = np.repeat(np.repeat(plane, vmax // v, axis=0), hmax // h, axis=1)
        planes.append(plane[:height, :width])
    if len(planes) == 1:
        g = planes[0].astype(np.uint8)
        return np.stack([g, g, g], axis=-1)
    return _ycc_to_rgb(*planes[:3])
