"""Image IO: a zlib PNG writer and a dependency-free OpenEXR subset.

Counterpart of ``ipu_path_trace_tpu/film/imageio.py``'s writers and
reader (single-part scanline EXR, NONE compression, HALF/FLOAT
channels).  PNGs are written with the standard library's zlib, so the
port needs no imaging package; for the same reason HDR images load from
OpenEXR only.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_EXR_MAGIC = b"\x76\x2f\x31\x01"
_PT_HALF = 1
_PT_FLOAT = 2


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, ldr: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image: 8-bit RGB, filter 0, one IDAT."""
    h, w, c = ldr.shape
    if c != 3 or ldr.dtype != np.uint8:
        raise ValueError("write_png expects an (H, W, 3) uint8 image")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), ldr.reshape(h, 3 * w)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(path: str, hdr: np.ndarray) -> None:
    """Write an (H, W, 3) float32 RGB image as scanline EXR (no compression)."""
    h, w, c = hdr.shape
    if c != 3:
        raise ValueError("write_exr expects RGB")
    chan = b""
    for name in (b"B", b"G", b"R"):  # alphabetical, as the format requires
        chan += name + b"\0" + struct.pack("<i", _PT_FLOAT) + b"\x00\x00\x00\x00"
        chan += struct.pack("<ii", 1, 1)
    chan += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join([
        _attr(b"channels", b"chlist", chan),
        _attr(b"compression", b"compression", b"\x00"),
        _attr(b"dataWindow", b"box2i", box),
        _attr(b"displayWindow", b"box2i", box),
        _attr(b"lineOrder", b"lineOrder", b"\x00"),
        _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
        b"\0",
    ])
    scan_bytes = 3 * w * 4
    data_start = len(_EXR_MAGIC) + 4 + len(header) + 8 * h
    offsets = [data_start + y * (8 + scan_bytes) for y in range(h)]
    img = hdr.astype(np.float32)
    with open(path, "wb") as f:
        f.write(_EXR_MAGIC)
        f.write(struct.pack("<I", 2))
        f.write(header)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, scan_bytes))
            f.write(img[y, :, 2].tobytes())
            f.write(img[y, :, 1].tobytes())
            f.write(img[y, :, 0].tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read scanline EXR (NONE compression, HALF/FLOAT) -> (H, W, 3) f32."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    channels: list[tuple[str, int]] = []
    data_window = compression = None
    while True:
        end = blob.index(b"\0", pos)
        if end == pos:
            pos += 1
            break
        name = blob[pos:end].decode()
        pos = end + 1
        end = blob.index(b"\0", pos)
        pos = end + 1
        (size,) = struct.unpack_from("<i", blob, pos)
        pos += 4
        payload = blob[pos:pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                ce = payload.index(b"\0", cp)
                (ptype,) = struct.unpack_from("<i", payload, ce + 1)
                channels.append((payload[cp:ce].decode(), ptype))
                cp = ce + 1 + 16
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)
        elif name == "compression":
            compression = payload[0]
    if compression != 0:
        raise ValueError("only NONE compression supported")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    out = {}
    for off in struct.unpack_from(f"<{h}Q", blob, pos):
        (y, _) = struct.unpack_from("<ii", blob, off)
        cur = off + 8
        for cname, ptype in channels:
            dt = np.float16 if ptype == _PT_HALF else np.float32
            out.setdefault(cname, np.zeros((h, w), np.float32))[y - y0] = np.frombuffer(
                blob, dt, count=w, offset=cur)
            cur += w * np.dtype(dt).itemsize
    return np.stack([out["R"], out["G"], out["B"]], axis=-1)


def load_hdr_image(path: str) -> np.ndarray:
    """Read an HDR image as float32 radiance (H, W, 3): OpenEXR through
    ``read_exr``.  Other formats need an imaging package the port does not
    depend on, so they raise."""
    if not path.lower().endswith(".exr"):
        raise ValueError(f"cannot read {path!r}: the port loads HDR images from OpenEXR "
                         "(.exr, scanline, no compression) only")
    return read_exr(path)


def save_images(path: str, hdr_at_step: np.ndarray, ldr: np.ndarray) -> None:
    """Write <path> (PNG, tone-mapped) and <base>.exr (HDR / step); an
    ``.exr`` outfile gets the HDR at that path and the PNG alongside."""
    base, ext = os.path.splitext(path)
    if ext.lower() == ".exr":
        write_exr(path, hdr_at_step)
        write_png(base + ".png", ldr)
        return
    write_png(path, ldr)
    write_exr(base + ".exr", hdr_at_step)
