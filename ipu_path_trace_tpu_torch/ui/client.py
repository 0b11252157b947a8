"""Remote-UI client: drives the render server over TCP.

Counterpart of ``ipu_path_trace_tpu/ui/client.py``, the port's own copy;
``preview_images`` decodes with the port's JPEG decoder (ui/jpeg.py)
instead of PIL.

The reference ships only the server side (the remote-ui client is a
separate repo, reference: README.md remote-ui instructions); this client
provides the counterpart for tests, scripting and headless preview
capture.
"""

from __future__ import annotations

import socket
import threading
from collections import deque

import numpy as np

from .packetcomms import (
    PacketDemuxer,
    PacketMuxer,
    pack_bool,
    pack_f32,
    pack_string,
    pack_u32,
    unpack_f32,
    unpack_f32vec,
    unpack_u32,
)


class InterfaceClient:
    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._tx = PacketMuxer(self._sock)
        # Subscribe BEFORE starting the rx loop or early server packets
        # (progress/hdr_header) are silently dropped (packetcomms.py
        # documents subscribe-first; the server does the same):
        self._rx = PacketDemuxer(self._sock, autostart=False)
        self.progress = 0.0
        self.path_rate = 0.0
        self.ray_rate = 0.0
        # Bounded: a long interactive run sends one JPEG per step.
        self.preview_frames: deque[bytes] = deque(maxlen=8)
        # Monotonic totals (the deque is bounded; rate measurements need
        # counters that never drop history):
        self.preview_count = 0
        self.preview_bytes = 0
        # Full preview byte stream (FMP4 video mode needs the init
        # segment + fragments contiguous); bounded to ~16 MiB.
        self.preview_stream = bytearray()
        self._hdr_shape: tuple[int, int] | None = None
        self._hdr_rows: dict[int, np.ndarray] = {}
        self._hdr_expected = 0
        self.hdr_complete = threading.Event()

        self._rx.subscribe("progress", self._on_progress)
        self._rx.subscribe("sample_rate", self._on_sample_rate)
        self._rx.subscribe("render_preview", self._on_preview)
        self._rx.subscribe("hdr_header", self._on_hdr_header)
        self._rx.subscribe("hdr_packet", self._on_hdr_packet)
        self._rx.start()

    # --- state updates (client -> server) ---
    def set_env_rotation(self, degrees: float):
        self._tx.send("env_rotation", pack_f32(degrees))

    def set_exposure(self, v: float):
        self._tx.send("exposure", pack_f32(v))

    def set_gamma(self, v: float):
        self._tx.send("gamma", pack_f32(v))

    def set_fov(self, degrees: float):
        self._tx.send("fov", pack_f32(degrees))

    def set_interactive_samples(self, n: int):
        self._tx.send("interactive_samples", pack_u32(n))

    def load_nif(self, path: str):
        self._tx.send("load_nif", pack_string(path))

    def stop_render(self):
        self._tx.send("stop", pack_bool(True))

    def detach(self):
        self._tx.send("detach", pack_bool(True))

    # --- incoming handlers ---
    def _on_preview(self, b: bytes):
        self.preview_frames.append(b)
        self.preview_count += 1
        self.preview_bytes += len(b)
        if len(self.preview_stream) < 16 * 1024 * 1024:
            self.preview_stream.extend(b)

    def preview_images(self) -> list[np.ndarray]:
        """Decode received preview data into RGB frames.

        Handles both server modes: an FMP4 MJPEG stream (one JPEG per
        mdat fragment; ui/video.iter_mp4_samples) and per-frame JPEG
        stills.  H.264 streams need an external decoder - the raw bytes
        stay available in ``preview_stream``.
        """
        from .jpeg import decode

        def _jpegs() -> list[bytes]:
            if self.preview_stream[4:8] == b"ftyp":
                from .video import iter_mp4_samples

                return list(iter_mp4_samples(bytes(self.preview_stream)))
            return list(self.preview_frames)

        out = []
        for data in _jpegs():
            if data[:2] != b"\xff\xd8":  # not JPEG (e.g. h264 sample)
                continue
            out.append(decode(data))
        return out

    def _on_progress(self, b: bytes):
        self.progress = unpack_f32(b)

    def _on_sample_rate(self, b: bytes):
        self.path_rate = unpack_f32(b[:4])
        self.ray_rate = unpack_f32(b[4:])

    def _on_hdr_header(self, b: bytes):
        w, h, chunks = unpack_u32(b[0:4]), unpack_u32(b[4:8]), unpack_u32(b[8:12])
        self._hdr_shape = (h, w)
        self._hdr_expected = chunks
        self._hdr_rows.clear()
        self.hdr_complete.clear()

    def _on_hdr_packet(self, b: bytes):
        row = unpack_u32(b[0:4])
        self._hdr_rows[row] = unpack_f32vec(b[4:])
        if len(self._hdr_rows) == self._hdr_expected:
            self.hdr_complete.set()

    def hdr_image(self) -> np.ndarray:
        if self._hdr_shape is None:
            raise RuntimeError("No HDR transfer received yet.")
        h, w = self._hdr_shape
        img = np.zeros((h, w, 3), np.float32)
        for row, data in self._hdr_rows.items():
            img[row] = data.reshape(w, 3)
        return img

    def close(self):
        self._rx.close()
        try:
            self._sock.close()
        except OSError:
            pass
