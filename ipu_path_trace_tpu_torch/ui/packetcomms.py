"""Low-latency TCP packet muxing - the packetcomms-library equivalent.

Counterpart of ``ipu_path_trace_tpu/ui/packetcomms.py``, the port's own
copy: the wire below is byte for byte the same, so either package's
client talks to either package's server.

The reference multiplexes typed packets over one TCP socket via its
packetcomms submodule (reference: src/InterfaceServer.hpp:8-11,96-97)
with cereal-serialised payloads.  This is the same design with an
explicit wire format (the reference's submodule is not vendored, so
parity is at the protocol/message-set level - SURVEY.md section 2.19):

  frame   := u32 type_id | u32 payload_size | payload bytes   (little endian)
  f32     := IEEE-754 LE
  u32/i32 := LE
  string  := u32 size | utf-8 bytes
  f32vec  := u32 count | f32 * count

Packet type ids index PACKET_TYPES, which matches the reference's
channel list exactly (InterfaceServer.hpp:23-42).
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import defaultdict
from typing import Callable

from ..utils.logging import logger

# Channel list and order of InterfaceServer.hpp:23-42:
PACKET_TYPES = (
    "stop",
    "detach",
    "progress",
    "sample_rate",
    "env_rotation",
    "exposure",
    "gamma",
    "fov",
    "load_nif",
    "render_preview",
    "hdr_header",
    "hdr_packet",
    "interactive_samples",
)
_TYPE_ID = {name: i for i, name in enumerate(PACKET_TYPES)}

_HEADER = struct.Struct("<II")


# --- payload packers -------------------------------------------------------


def pack_f32(v: float) -> bytes:
    return struct.pack("<f", v)


def unpack_f32(b: bytes) -> float:
    return struct.unpack("<f", b)[0]


def pack_u32(v: int) -> bytes:
    return struct.pack("<I", v)


def unpack_u32(b: bytes) -> int:
    return struct.unpack("<I", b)[0]


def pack_bool(v: bool) -> bytes:
    return struct.pack("<B", 1 if v else 0)


def unpack_bool(b: bytes) -> bool:
    return b[0] != 0


def pack_string(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack("<I", len(raw)) + raw


def unpack_string(b: bytes) -> str:
    (n,) = struct.unpack_from("<I", b, 0)
    return b[4 : 4 + n].decode("utf-8")


def pack_f32vec(values) -> bytes:
    import numpy as np

    arr = np.asarray(values, np.float32)
    return struct.pack("<I", arr.size) + arr.tobytes()


def unpack_f32vec(b: bytes):
    import numpy as np

    (n,) = struct.unpack_from("<I", b, 0)
    return np.frombuffer(b, np.float32, count=n, offset=4)


# --- socket helpers --------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except (OSError, ValueError):
            return None
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


class PacketMuxer:
    """Thread-safe typed-packet sender over a connected socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._lock = threading.Lock()
        self._ok = True

    def ok(self) -> bool:
        return self._ok

    def send(self, packet_type: str, payload: bytes) -> bool:
        frame = _HEADER.pack(_TYPE_ID[packet_type], len(payload)) + payload
        with self._lock:
            try:
                self._sock.sendall(frame)
                return True
            except OSError:
                self._ok = False
                return False


class PacketDemuxer:
    """Receive thread dispatching packets to per-type subscribers."""

    def __init__(self, sock: socket.socket, autostart: bool = True):
        self._sock = sock
        self._subs: dict[str, list[Callable[[bytes], None]]] = defaultdict(list)
        self._ok = True
        self._thread = threading.Thread(target=self._rx_loop, daemon=True, name="packet_rx")
        if autostart:
            self._thread.start()

    def start(self) -> None:
        """Start the rx loop (use autostart=False to subscribe first -
        packets for types with no subscriber are dropped)."""
        if not self._thread.is_alive():
            self._thread.start()

    def subscribe(self, packet_type: str, fn: Callable[[bytes], None]) -> None:
        if packet_type not in _TYPE_ID:
            raise KeyError(f"Unknown packet type '{packet_type}'")
        self._subs[packet_type].append(fn)

    def ok(self) -> bool:
        return self._ok

    def close(self) -> None:
        self._ok = False
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)

    def _rx_loop(self) -> None:
        while self._ok:
            header = _recv_exact(self._sock, _HEADER.size)
            if header is None:
                break
            type_id, size = _HEADER.unpack(header)
            payload = _recv_exact(self._sock, size) if size else b""
            if payload is None:
                break
            if type_id >= len(PACKET_TYPES):
                logger().warning("Dropping packet with unknown type id %d", type_id)
                continue
            name = PACKET_TYPES[type_id]
            for fn in self._subs.get(name, ()):
                try:
                    fn(payload)
                except Exception as e:
                    logger().error("Packet handler for '%s' raised: %s", name, e)
        self._ok = False
