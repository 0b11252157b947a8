"""Remote user-interface server (reference: src/InterfaceServer.hpp).

Counterpart of ``ipu_path_trace_tpu/ui/server.py``, the port's own copy:
the same 13 channels, state machine and wire.  Its JPEG stills come from
the port's coder (ui/jpeg.py, native) instead of PIL.

A TCP server thread accepting one client and exchanging the reference's
13 packet channels: state updates from the client (env_rotation,
exposure, gamma, fov, load_nif, interactive_samples, stop, detach) and
streamed results to the client (progress, sample_rate, render_preview,
hdr_header/hdr_packet).

Behaviour parity notes:
  * exposure/gamma changes do NOT mark state updated - tone mapping is
    host-side, so no render restart (InterfaceServer.hpp:131-143).
  * fov arrives in degrees and stays degrees here (our app tracks
    degrees; the reference converts to radians on receipt because its
    app tracks radians - same semantics).
  * render_preview carries a fragmented-MP4 video stream like the
    reference's videolib output (InterfaceServer.hpp:100-108): H.264
    via an ffmpeg subprocess when the binary exists, else the
    dependency-free MJPEG-in-fMP4 muxer (ui/video.py).  Wire parity is
    protocol-level (channel + ISO-BMFF framing), not byte-level.
    Before initialise_video_stream() the channel falls back to plain
    JPEG stills.
  * raw HDR transfer: one row per hdr_packet, 2 ms throttle
    (InterfaceServer.hpp:280-331).
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np

from ..utils.logging import logger
from .packetcomms import (
    PacketDemuxer,
    PacketMuxer,
    pack_f32,
    pack_f32vec,
    pack_u32,
    unpack_bool,
    unpack_f32,
    unpack_string,
    unpack_u32,
)


class InterfaceServer:
    def __init__(self, port: int):
        self.port = port
        self._state = self._default_state()
        self._state_lock = threading.Lock()
        self._state_updated = False
        self._client_set: set[str] = set()  # fields a client actually sent
        self._stop_server = False
        self._server_ready = threading.Event()
        self._thread: threading.Thread | None = None
        self._sender: PacketMuxer | None = None
        self._receiver: PacketDemuxer | None = None
        self._listen_sock: socket.socket | None = None
        self._conn: socket.socket | None = None
        self._hdr_thread: threading.Thread | None = None
        self._video_size: tuple[int, int] | None = None
        self._video = None  # render_preview video encoder (ui/video.py)
        self._client_connected = threading.Event()
        self._failed = False

    @staticmethod
    def _default_state() -> dict:
        # Field set of InterfaceServer::State (InterfaceServer.hpp:192-201):
        return {
            "env_rotation": 0.0,
            "exposure": 0.0,
            "gamma": 2.2,
            "fov": 90.0,
            "interactive_samples": 8,
            "load_nif": "",
            "stop": False,
            "detach": False,
        }

    # ------------------------------------------------------------------
    def start(self) -> None:
        """Launch the server thread; blocks until a client connects
        (InterfaceServer.hpp:230-236)."""
        self._stop_server = False
        self._server_ready.clear()
        self._thread = threading.Thread(target=self._communicate, name="ui_server", daemon=True)
        self._thread.start()
        self._server_ready.wait()

    def wait_for_client(self, timeout: float | None = None) -> bool:
        """Block until a client connects (the reference's start() blocks
        inside waitForServerReady, InterfaceServer.hpp:177-182,230-236).

        Returns False on server failure (e.g. the port is already in
        use) as well as on timeout."""
        ok = self._client_connected.wait(timeout)
        return ok and not self._failed

    def stop(self) -> None:
        self._stop_server = True
        if self._receiver is not None:
            self._receiver.close()
        for sock in (self._conn, self._listen_sock):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._hdr_thread is not None:
            self._hdr_thread.join(timeout=5)
            self._hdr_thread = None

    def _communicate(self) -> None:
        """Accept loop: serve one client at a time, forever.

        After a client disconnects the per-client state is torn down and
        the server returns to accept() - matching the reference's
        defunct-state machine that survives reconnect cycles
        (InterfaceServer.hpp / PathTracerApp.cpp:511-529) rather than
        requiring a process restart.
        """
        logger().info("User interface server listening on port %d", self.port)
        try:
            self._listen_sock = socket.create_server(("0.0.0.0", self.port))
            if self.port == 0:
                self.port = self._listen_sock.getsockname()[1]
            self._server_ready.set()  # port is bound; client may connect now
            self._listen_sock.settimeout(1.0)
            while not self._stop_server:
                conn = None
                try:
                    conn, _addr = self._listen_sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    if self._stop_server:
                        return
                    raise
                self._serve_client(conn)
                self._teardown_client()
        except OSError as e:
            logger().error("UI server socket error: %s", e)
            self._failed = True
            self._server_ready.set()
            # Unblock wait_for_client(); it reports failure via _failed:
            self._client_connected.set()
        finally:
            logger().info("User interface server accept loop exited.")

    def _serve_client(self, conn: socket.socket) -> None:
        """Tx/Rx loop for one connected client until disconnect or stop."""
        self._conn = conn
        logger().info("User interface client connected.")
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Subscribe before starting the rx loop so no early client
        # packet is dropped; only then signal readiness (mirrors the
        # reference setting serverReady after subscriptions,
        # InterfaceServer.hpp:110-169):
        rx = PacketDemuxer(conn, autostart=False)
        self._receiver = rx

        def set_state(k, v, updates=True):
            with self._state_lock:
                self._state[k] = v
                self._client_set.add(k)
                if updates:
                    self._state_updated = True

        rx.subscribe("env_rotation", lambda b: set_state("env_rotation", unpack_f32(b)))
        rx.subscribe("detach", lambda b: set_state("detach", unpack_bool(b)))
        rx.subscribe("stop", lambda b: set_state("stop", unpack_bool(b)))
        # Tone-mapping is host-side: no restart on exposure/gamma
        # (InterfaceServer.hpp:131-143):
        rx.subscribe("exposure", lambda b: set_state("exposure", unpack_f32(b), updates=False))
        rx.subscribe("gamma", lambda b: set_state("gamma", unpack_f32(b), updates=False))
        rx.subscribe("fov", lambda b: set_state("fov", unpack_f32(b)))
        rx.subscribe("load_nif", lambda b: set_state("load_nif", unpack_string(b)))
        rx.subscribe(
            "interactive_samples",
            lambda b: set_state("interactive_samples", unpack_u32(b)),
        )

        rx.start()
        self._sender = PacketMuxer(conn)
        self._client_connected.set()
        logger().info("User interface server entering Tx/Rx loop.")
        while not self._stop_server and rx.ok():
            time.sleep(0.005)
        logger().info("User interface server Tx/Rx loop exited.")

    def _teardown_client(self) -> None:
        """Reset per-client state so a new client can attach."""
        self._client_connected.clear()
        self._sender = None
        rx, self._receiver = self._receiver, None
        if rx is not None:
            rx.close()
        if self._hdr_thread is not None:
            self._hdr_thread.join(timeout=5)
            self._hdr_thread = None
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        # A fresh client needs a fresh stream (it missed the init segment):
        if self._video is not None and self._video_size is not None:
            try:
                self._video.close()
            except Exception:  # noqa: BLE001
                pass
            self.initialise_video_stream(*self._video_size)

    # --- state API (consumeState/stateChanged, InterfaceServer.hpp:204-218) ---
    def seed_state(self, values: dict) -> None:
        """Install the render's ACTUAL initial values (from the CLI/config)
        for any field no client has sent yet.  Without this, the first
        consumed state change would clobber CLI values (e.g. --fov 40,
        --interactive-samples 32) with the protocol defaults above."""
        with self._state_lock:
            for k, v in values.items():
                if k not in self._state:
                    raise KeyError(f"unknown UI state field '{k}'")
                if k not in self._client_set:
                    self._state[k] = v

    def state_changed(self) -> bool:
        return self._state_updated

    def consume_state(self) -> dict:
        with self._state_lock:
            snapshot = dict(self._state)
            self._state_updated = False
            self._state["load_nif"] = ""
        return snapshot

    def get_state(self) -> dict:
        with self._state_lock:
            return dict(self._state)

    # --- outgoing channels -------------------------------------------------
    def initialise_video_stream(self, width: int, height: int) -> None:
        """Set up FMP4 video on render_preview (InterfaceServer.hpp:238-244).

        Falls back to per-frame JPEG stills if no encoder can start.
        """
        self._video_size = (width, height)
        try:
            from .video import make_encoder

            self._video = make_encoder(width, height)
            logger().info(
                "render_preview video stream: %s %dx%d",
                self._video.codec, width, height,
            )
        except Exception as e:  # noqa: BLE001 - any encoder failure -> stills
            logger().warning("Video encoder unavailable (%s); using JPEG stills.", e)
            self._video = None

    def update_progress(self, step: int, total_steps: int) -> None:
        sender = self._sender
        if sender is not None:
            sender.send("progress", pack_f32(step / float(total_steps)))

    def update_sample_rate(self, path_rate: float, ray_rate: float) -> None:
        # SampleRates struct: two f32 (InterfaceServer.hpp:73-81):
        sender = self._sender
        if sender is not None:
            sender.send("sample_rate", pack_f32(path_rate) + pack_f32(ray_rate))

    def send_preview_image(self, ldr: np.ndarray) -> None:
        """Encode the tone-mapped frame onto render_preview.

        Emits FMP4 video fragments when a stream was initialised and an
        encoder is available (the reference's videolib/FFmpeg behaviour,
        InterfaceServer.hpp:100-108,272-278), falling back to per-frame
        JPEG stills otherwise.
        """
        sender = self._sender
        if sender is None:
            return
        video = self._video
        if video is not None:
            try:
                for chunk in video.encode(ldr):
                    sender.send("render_preview", chunk)
                return
            except Exception as e:  # noqa: BLE001
                # Encoder died mid-stream (ffmpeg without the codec exits
                # after startup; or a client-disconnect teardown closed it
                # concurrently).  A preview must never abort the render:
                # drop this encoder and fall back to JPEG stills - unless
                # teardown already installed a fresh one for the next
                # client, which we must not clobber.
                logger().warning(
                    "Preview video encode failed (%s); falling back to JPEG stills.", e
                )
                if self._video is video:
                    self._video = None
                    try:
                        video.close()
                    except Exception:  # noqa: BLE001
                        pass
        from .jpeg import encode as jpeg_encode

        sender.send("render_preview", jpeg_encode(np.ascontiguousarray(ldr, np.uint8)))

    def start_sending_raw_image(self, hdr: np.ndarray) -> bool:
        """Chunked uncompressed HDR transfer (InterfaceServer.hpp:280-331).

        hdr must already be normalised by step (the app passes
        film.hdr_at_step).  Sends hdr_header{w,h,chunks} then one row per
        hdr_packet{id, f32vec}, throttled 2 ms per packet on a background
        thread.  Returns False if a transfer is still in flight.
        """
        if self._sender is None:
            return False
        if self._hdr_thread is not None and self._hdr_thread.is_alive():
            logger().debug("Large data transfer still in progress, dropping request")
            return False
        if self._hdr_thread is not None:
            self._hdr_thread.join()
        h, w, c = hdr.shape
        if c != 3:
            raise ValueError("Only transmission of 3 channel raw data is supported.")
        sender = self._sender
        sender.send("hdr_header", pack_u32(w) + pack_u32(h) + pack_u32(h))
        data = np.ascontiguousarray(hdr, np.float32)

        def tx():
            # The muxer is captured locally: _teardown_client nulls
            # self._sender while a transfer is in flight (a 1000-row
            # frame takes ~2 s at the throttle); sending on the closed
            # muxer returns False -> the clean abort below.
            t0 = time.monotonic()
            for row in range(h):
                if not sender.send(
                    "hdr_packet", pack_u32(row) + pack_f32vec(data[row].ravel())
                ):
                    logger().warning("Raw image transfer aborted (client gone).")
                    return
                time.sleep(0.002)  # keep the link interactive
            mib = data.nbytes / (1024.0 * 1024.0)
            logger().info(
                "%.1f MiB raw image transmitted in %.2f seconds", mib, time.monotonic() - t0
            )

        self._hdr_thread = threading.Thread(target=tx, name="hdr_tx", daemon=True)
        self._hdr_thread.start()
        return True

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
