"""Video encoding for the render_preview channel.

Counterpart of ``ipu_path_trace_tpu/ui/video.py``: the ISO-BMFF muxer is
the port's own copy, byte for byte the same boxes; the MJPEG samples
come from the port's JPEG coder (ui/jpeg.py, native) instead of PIL.

The reference streams FFmpeg-encoded fragmented-MP4 video to the remote
UI on its ``render_preview`` channel (reference:
src/InterfaceServer.hpp:100-108,238-244,272-278 via the videolib
submodule).  This module provides that wire format without a hard
FFmpeg dependency:

* ``Fmp4MjpegEncoder`` - a dependency-free fragmented-MP4 muxer
  (ISO/IEC 14496-12 ``ftyp``/``moov``/``moof``/``mdat`` boxes) carrying
  Motion-JPEG samples.  Every frame is intra-coded, so fragments are
  independently decodable after the init segment - any FFmpeg-based
  client (like the reference's remote-ui) can open the byte stream as
  an ``mp4`` with an ``mjpeg`` track.
* ``FfmpegH264Encoder`` - pipes raw frames through an ``ffmpeg``
  subprocess producing H.264 in fragmented MP4 (frag-per-keyframe,
  zero-latency), matching the reference's codec when the binary is
  present.

``make_encoder`` picks H.264 when ``ffmpeg`` exists on PATH and the
frame size is even (libx264's yuv420p constraint), else MJPEG.
``iter_mp4_samples`` is the client-side helper: it walks top-level
boxes of the concatenated stream and yields one sample payload per
``mdat`` (for the MJPEG track: one JPEG image per fragment).
"""

from __future__ import annotations

import shutil
import struct
import subprocess
import threading
from collections import deque
from typing import Iterator

import numpy as np

TIMESCALE = 90_000  # standard 90 kHz media clock


# --- ISO-BMFF box builders ---------------------------------------------------


def _box(btype: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + btype + body


def _full(btype: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(btype, struct.pack(">I", (version << 24) | flags), *payload)


_UNITY_MATRIX = struct.pack(">9i", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000)


def _jpeg_sample_entry(width: int, height: int) -> bytes:
    """VisualSampleEntry with the 'jpeg' coding name (MJPEG in MP4)."""
    name = b"ipu_path_trace_tpu mjpeg"
    compressor = bytes([len(name)]) + name + b"\0" * (31 - len(name))
    return _box(
        b"jpeg",
        b"\0" * 6,  # reserved
        struct.pack(">H", 1),  # data_reference_index
        struct.pack(">HH", 0, 0),  # pre_defined, reserved
        struct.pack(">3I", 0, 0, 0),  # pre_defined
        struct.pack(">HH", width, height),
        struct.pack(">II", 0x00480000, 0x00480000),  # 72 dpi x/y
        struct.pack(">I", 0),  # reserved
        struct.pack(">H", 1),  # frame_count
        compressor,
        struct.pack(">Hh", 0x0018, -1),  # depth, pre_defined
    )


def _init_segment(width: int, height: int) -> bytes:
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso5iso6mp41")
    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">III", 0, 0, TIMESCALE),  # creation, modification, timescale
        struct.pack(">I", 0),  # duration (unknown: fragmented)
        struct.pack(">iH", 0x00010000, 0x0100),  # rate, volume
        b"\0" * 10,  # reserved
        _UNITY_MATRIX,
        b"\0" * 24,  # pre_defined
        struct.pack(">I", 2),  # next_track_ID
    )
    tkhd = _full(
        b"tkhd", 0, 0x7,  # enabled | in_movie | in_preview
        struct.pack(">III", 0, 0, 1),  # creation, modification, track_ID
        struct.pack(">I", 0),  # reserved
        struct.pack(">I", 0),  # duration
        b"\0" * 8,  # reserved
        struct.pack(">HHHH", 0, 0, 0, 0),  # layer, alt_group, volume, reserved
        _UNITY_MATRIX,
        struct.pack(">II", width << 16, height << 16),
    )
    mdhd = _full(
        b"mdhd", 0, 0,
        struct.pack(">IIII", 0, 0, TIMESCALE, 0),
        struct.pack(">HH", 0x55C4, 0),  # language 'und', pre_defined
    )
    hdlr = _full(
        b"hdlr", 0, 0,
        struct.pack(">I", 0), b"vide", b"\0" * 12, b"VideoHandler\0",
    )
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">4H", 0, 0, 0, 0))
    dinf = _box(
        b"dinf",
        _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)),
    )
    stbl = _box(
        b"stbl",
        _full(b"stsd", 0, 0, struct.pack(">I", 1), _jpeg_sample_entry(width, height)),
        _full(b"stts", 0, 0, struct.pack(">I", 0)),
        _full(b"stsc", 0, 0, struct.pack(">I", 0)),
        _full(b"stsz", 0, 0, struct.pack(">II", 0, 0)),
        _full(b"stco", 0, 0, struct.pack(">I", 0)),
    )
    minf = _box(b"minf", vmhd, dinf, stbl)
    mdia = _box(b"mdia", mdhd, hdlr, minf)
    trak = _box(b"trak", tkhd, mdia)
    trex = _full(b"trex", 0, 0, struct.pack(">5I", 1, 1, 0, 0, 0))
    moov = _box(b"moov", mvhd, trak, _box(b"mvex", trex))
    return ftyp + moov


def _fragment(seq: int, decode_time: int, duration: int, sample: bytes) -> bytes:
    """One moof+mdat pair carrying a single sample."""

    def build(data_offset: int) -> bytes:
        mfhd = _full(b"mfhd", 0, 0, struct.pack(">I", seq))
        tfhd = _full(b"tfhd", 0, 0x020000, struct.pack(">I", 1))  # base-is-moof
        tfdt = _full(b"tfdt", 1, 0, struct.pack(">Q", decode_time))
        # data-offset | sample-duration | sample-size present:
        trun = _full(
            b"trun", 0, 0x000301,
            struct.pack(">IiII", 1, data_offset, duration, len(sample)),
        )
        return _box(b"moof", mfhd, _box(b"traf", tfhd, tfdt, trun))

    moof = build(0)
    moof = build(len(moof) + 8)  # sample starts right after the mdat header
    return moof + _box(b"mdat", sample)


def iter_mp4_boxes(data: bytes) -> Iterator[tuple[bytes, bytes]]:
    """Yield (type, payload) for each complete top-level box in data."""
    off = 0
    while off + 8 <= len(data):
        size, btype = struct.unpack_from(">I4s", data, off)
        if size < 8 or off + size > len(data):
            return
        yield btype, data[off + 8 : off + size]
        off += size


def iter_mp4_samples(data: bytes) -> Iterator[bytes]:
    """Yield mdat payloads (one encoded sample each for our fragments)."""
    for btype, payload in iter_mp4_boxes(data):
        if btype == b"mdat":
            yield payload


# --- encoders ----------------------------------------------------------------


class Fmp4MjpegEncoder:
    """Dependency-free fragmented-MP4 Motion-JPEG encoder.

    ``encode(frame)`` returns a list of byte chunks to transmit: the
    init segment on the first call, then one moof+mdat fragment per
    frame.  Each chunk is a self-delimiting ISO-BMFF run, so chunk
    boundaries can double as packet boundaries.
    """

    codec = "mjpeg/fmp4"

    def __init__(self, width: int, height: int, fps: int = 24, quality: int = 85):
        self.width, self.height, self.fps = width, height, fps
        self.quality = quality
        self._seq = 0
        self._sent_init = False

    def encode(self, frame: np.ndarray) -> list[bytes]:
        from .jpeg import encode as jpeg_encode

        if frame.shape[:2] != (self.height, self.width):
            raise ValueError(
                f"frame is {frame.shape[1]}x{frame.shape[0]}, "
                f"stream is {self.width}x{self.height}"
            )
        sample = jpeg_encode(np.ascontiguousarray(frame, np.uint8), self.quality)
        duration = TIMESCALE // self.fps
        chunks = []
        if not self._sent_init:
            chunks.append(_init_segment(self.width, self.height))
            self._sent_init = True
        chunks.append(_fragment(self._seq + 1, self._seq * duration, duration, sample))
        self._seq += 1
        return chunks

    def close(self) -> list[bytes]:  # symmetric with FfmpegH264Encoder
        """No buffering: every fragment is returned from encode()."""
        return []


class FfmpegH264Encoder:
    """H.264 fragmented-MP4 via an ffmpeg subprocess (when installed).

    Matches the reference's codec (videolib drives libav/x264).  Frames
    are piped in as raw RGB; encoded bytes are drained from stdout by a
    reader thread and returned from the next encode() call.
    """

    codec = "h264/fmp4"

    def __init__(self, width: int, height: int, fps: int = 24):
        if width % 2 or height % 2:
            raise ValueError("h264/yuv420p needs even frame dimensions")
        self.width, self.height = width, height
        self._chunks: deque[bytes] = deque()
        self._proc = subprocess.Popen(
            [
                "ffmpeg", "-hide_banner", "-loglevel", "error",
                "-f", "rawvideo", "-pix_fmt", "rgb24",
                "-s", f"{width}x{height}", "-r", str(fps), "-i", "-",
                "-an", "-c:v", "libx264", "-preset", "ultrafast",
                "-tune", "zerolatency", "-pix_fmt", "yuv420p",
                "-f", "mp4",
                "-movflags", "frag_keyframe+empty_moov+default_base_moof",
                "-",
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        while True:
            chunk = self._proc.stdout.read(65536)
            if not chunk:
                return
            self._chunks.append(chunk)

    def encode(self, frame: np.ndarray) -> list[bytes]:
        self._proc.stdin.write(np.ascontiguousarray(frame, np.uint8).tobytes())
        self._proc.stdin.flush()
        out = []
        while self._chunks:
            out.append(self._chunks.popleft())
        return out

    def close(self) -> list[bytes]:
        """Finish the stream and return any trailing encoded bytes the
        codec emitted after the last encode() call (x264 buffers frames;
        dropping the tail would truncate a written MP4)."""
        if self._proc.stdin:
            try:
                self._proc.stdin.close()
            except OSError:
                pass
        self._proc.wait(timeout=10)
        self._reader.join(timeout=10)
        out = []
        while self._chunks:
            out.append(self._chunks.popleft())
        return out


def make_encoder(width: int, height: int, fps: int = 24):
    """Best available render_preview encoder for this host.

    H.264 (reference codec) when ffmpeg is on PATH and the size is
    even; the dependency-free MJPEG muxer otherwise.
    """
    if shutil.which("ffmpeg") and width % 2 == 0 and height % 2 == 0:
        try:
            return FfmpegH264Encoder(width, height, fps)
        except (OSError, ValueError):
            pass
    return Fmp4MjpegEncoder(width, height, fps)
