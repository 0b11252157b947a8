"""The port's remote UI (ui/) against the JAX package, on localhost.

* every ``pack_*`` of packetcomms gives the JAX package's bytes and its
  ``unpack_*`` reads them back;
* the fMP4 init segment and fragments are byte for byte the JAX
  package's for the same JPEG sample;
* a JAX client drives the port's server and the port's client the JAX
  server;
* the JPEG coder: the NumPy encoder's bytes decoded by PIL lie within
  0.5 dB PSNR of PIL's own quality-85 file of the same image (PIL exists
  in the tests only), the port's decoder agrees with PIL's decode of
  the port's bytes within 1 code value, and the native encoder is byte
  for byte the NumPy one;
* ``app.execute(ui_server=...)`` with the port's client, host film and
  device film, with and without --denoise: previews arrive, an exposure
  change does not restart, a fov change does (progress starts again at
  step 1), an invalid interactive_samples is ignored, stop ends the
  render;
* --ui-port on a port that is taken fails at once.
"""

import io
import socket
import threading
import time

import numpy as np
import pytest
from PIL import Image

from ipu_path_trace_tpu.ui import InterfaceClient as JClient
from ipu_path_trace_tpu.ui import InterfaceServer as JServer
from ipu_path_trace_tpu.ui import packetcomms as jpc
from ipu_path_trace_tpu.ui import video as jvideo
from ipu_path_trace_tpu_torch.runtime import cli, native
from ipu_path_trace_tpu_torch.runtime.app import PathTracerApp
from ipu_path_trace_tpu_torch.ui import InterfaceClient, InterfaceServer, jpeg, video
from ipu_path_trace_tpu_torch.ui import packetcomms as pc


def _wait(pred, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _image(seed, h, w):
    """A seeded frame with smooth gradients, edges and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 5.0) * 100 + 128, np.cos(y / 4.0) * 90 + 128,
                     ((x // 8 + y // 8) % 2) * 160 + 40], axis=-1)
    return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(float) - b.astype(float)) ** 2))


# --- the wire ---------------------------------------------------------------------------------


@pytest.mark.parametrize("kind,value", [
    ("f32", 0.1), ("f32", -3.5e7), ("u32", 0), ("u32", 4_000_000_000), ("bool", True),
    ("bool", False), ("string", ""), ("string", "assets/urban_alley_synth_nif"),
    ("string", "ünïcode"), ("f32vec", [1.0, -2.5, 3.25e-3]), ("f32vec", [])])
def test_packetcomms_byte_for_byte(kind, value):
    ours = getattr(pc, f"pack_{kind}")(value)
    assert ours == getattr(jpc, f"pack_{kind}")(value)
    back = getattr(pc, f"unpack_{kind}")(ours)
    ref = getattr(jpc, f"unpack_{kind}")(ours)
    if kind == "f32vec":
        np.testing.assert_array_equal(back, ref)
    else:
        assert back == ref
    assert pc.PACKET_TYPES == jpc.PACKET_TYPES


@pytest.mark.parametrize("w,h", [(16, 16), (1104, 1000), (33, 7)])
def test_fmp4_boxes_byte_for_byte(w, h):
    sample = jpeg.encode(_image(1, 16, 16))
    assert video._init_segment(w, h) == jvideo._init_segment(w, h)
    for seq, t in ((1, 0), (7, 22_500)):
        assert video._fragment(seq, t, 3750, sample) == jvideo._fragment(seq, t, 3750, sample)
    enc = video.Fmp4MjpegEncoder(16, 16)
    frame = _image(2, 16, 16)
    first, second = enc.encode(frame), enc.encode(frame)
    assert first == [jvideo._init_segment(16, 16),
                     jvideo._fragment(1, 0, 3750, jpeg.encode(frame))]
    assert second == [jvideo._fragment(2, 3750, 3750, jpeg.encode(frame))]
    samples = list(video.iter_mp4_samples(b"".join(first + second)))
    assert samples == list(jvideo.iter_mp4_samples(b"".join(first + second)))
    assert len(samples) == 2 and samples[0][:2] == b"\xff\xd8"


# --- JPEG ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(64, 64), (37, 53), (1, 1), (48, 80)])
def test_jpeg_plain_encoder_against_pil(h, w):
    img = _image(h * 100 + w, h, w)
    ours = jpeg.encode_plain(img)
    in_pil = np.asarray(Image.open(io.BytesIO(ours)).convert("RGB"))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=85)
    pil = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    assert in_pil.shape == img.shape
    if h * w > 1:
        assert _psnr(img, in_pil) >= _psnr(img, pil) - 0.5
    else:
        assert np.abs(in_pil.astype(int) - img.astype(int)).max() <= 2
    ours_decoded = jpeg.decode(ours)
    assert ours_decoded.shape == img.shape and ours_decoded.dtype == np.uint8
    assert np.abs(ours_decoded.astype(int) - in_pil.astype(int)).max() <= 1


def test_jpeg_decoder_reads_pil_files():
    """PIL's own quality-85 4:2:0 file decodes as PIL decodes it (1 code
    value), so the port's client reads the JAX server's stills."""
    img = _image(4, 40, 56)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=85)
    pil = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    assert np.abs(jpeg.decode(buf.getvalue()).astype(int) - pil.astype(int)).max() <= 1


def _extreme(kind, h=40, w=56):
    y, x = np.mgrid[0:h, 0:w]
    if kind == "checker":
        return np.repeat((((x + y) % 2) * 255)[..., None], 3, axis=-1).astype(np.uint8)
    if kind == "black":
        return np.zeros((h, w, 3), np.uint8)
    if kind == "white":
        return np.full((h, w, 3), 255, np.uint8)
    if kind == "stripes":
        return np.stack([(x % 2) * 255, (y % 2) * 255, ((x + 1) % 2) * 255], -1).astype(np.uint8)
    return np.random.default_rng(11).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["checker", "black", "white", "stripes", "noise", "smooth"])
def test_native_jpeg_byte_for_byte(kind):
    img = _image(5, 75, 101) if kind == "smooth" else _extreme(kind)
    before = native.jpeg_scan.calls
    assert jpeg.encode(img) == jpeg.encode_plain(img)
    assert native.jpeg_scan.calls == before + 1


def test_jpeg_rejects_bad_frames():
    with pytest.raises(ValueError):
        jpeg.encode(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        jpeg.encode(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        jpeg.decode(b"not a jpeg")


# --- the two packages talk to each other ------------------------------------------------------


@pytest.mark.parametrize("server_cls,client_cls", [(InterfaceServer, JClient),
                                                    (JServer, InterfaceClient)])
def test_cross_package_client_and_server(server_cls, client_cls):
    server = server_cls(0)
    server.start()
    client = client_cls("127.0.0.1", server.port)
    try:
        assert server.wait_for_client(5)
        client.set_fov(60.0)
        client.set_env_rotation(45.0)
        client.set_interactive_samples(4)
        client.load_nif("assets/x")
        client.set_exposure(1.5)
        assert _wait(lambda: server.get_state()["interactive_samples"] == 4
                     and server.get_state()["fov"] == 60.0
                     and server.get_state()["load_nif"] == "assets/x"
                     and server.get_state()["exposure"] == 1.5)
        state = server.consume_state()
        assert (state["env_rotation"], state["gamma"]) == (45.0, 2.2)
        img = _image(6, 16, 24)
        server.send_preview_image(img)  # a still before the stream
        server.initialise_video_stream(24, 16)
        server.send_preview_image(img)
        server.update_progress(3, 12)
        server.update_sample_rate(2.0e6, 1.0e7)
        assert _wait(lambda: client.preview_count >= 3 and client.progress == 0.25
                     and client.ray_rate == 1.0e7)
        frames = client.preview_images()
        assert frames and all(f.shape == (16, 24, 3) for f in frames)
        assert all(_psnr(img, f) > 20.0 for f in frames)  # the frame sent, at quality 85
        hdr = np.random.default_rng(7).random((5, 6, 3)).astype(np.float32)
        assert server.start_sending_raw_image(hdr)
        assert client.hdr_complete.wait(10)
        np.testing.assert_array_equal(client.hdr_image(), hdr)
        client.stop_render()
        assert _wait(lambda: server.get_state()["stop"])
    finally:
        client.close()
        server.stop()


# --- the render loop under the UI -------------------------------------------------------------

UI_ARGS = ["-w", "16", "-H", "16", "-s", "4000", "--samples-per-step", "4",
           "--interactive-samples", "2", "--max-path-length", "3",
           "--assets", "constant:0.6,0.5,0.4", "--device", "cpu", "--ui-port", "1"]


@pytest.mark.parametrize("flags", [[], ["--denoise", "--denoise-iters", "2"], ["--device-film"],
                                   ["--device-film", "--denoise", "--denoise-iters", "2"]])
def test_app_execute_under_the_ui(tmp_path, flags):
    cfg = cli.parse_config([*UI_ARGS, "-o", str(tmp_path / "ui.png"), *flags])
    app = PathTracerApp(cfg)
    app.init()
    app.build()
    statuses = []
    process = app._process_user_input
    app._process_user_input = lambda s: statuses.append(process(s)) or statuses[-1]
    server = InterfaceServer(0)
    server.start()
    client = InterfaceClient("127.0.0.1", server.port)
    progress = []
    on_progress = client._on_progress
    client._rx._subs["progress"] = [lambda b: (on_progress(b), progress.append(client.progress))]
    t = threading.Thread(target=app.execute, kwargs=dict(ui_server=server))
    try:
        assert server.wait_for_client(5)
        server.initialise_video_stream(16, 16)
        t.start()
        assert _wait(lambda: client.preview_count >= 3)
        client.set_exposure(1.0)
        assert _wait(lambda: app.state["exposure"] == 1.0)
        assert "restart" not in statuses
        seen = len(progress)
        client.set_fov(60.0)
        assert _wait(lambda: "restart" in statuses and progress[seen:].count(progress[0]))
        assert app.state["fov"] == 60.0 and app.samples_per_step == 2
        n = len(statuses)
        client.set_interactive_samples(0)
        assert _wait(lambda: len(statuses) > n)
        assert statuses[-1] == "none" and app.state["interactive_samples"] == 2
        frames = client.preview_images()
        assert frames and frames[-1].shape == (16, 16, 3)
    finally:
        client.stop_render()
        t.join(60)
        alive = t.is_alive()
        client.close()
        server.stop()
    assert not alive and statuses[-1] == "stop"
    assert (tmp_path / "ui.png").exists() and (tmp_path / "ui.exr").exists()


def test_cli_ui_port_in_use_fails_fast(tmp_path):
    blocker = socket.create_server(("0.0.0.0", 0))
    port = blocker.getsockname()[1]
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="port in use"):
            cli.main(["-w", "8", "-H", "8", "-s", "1", "--samples-per-step", "1",
                      "--assets", "constant:1,1,1", "-o", str(tmp_path / "x.png"),
                      "--device", "cpu", "--ui-port", str(port)])
        assert time.monotonic() - t0 < 30
    finally:
        blocker.close()


@pytest.mark.parametrize("flags", [["--interactive-samples", "70000"],
                                   ["--ui-port", "5", "--device-film", "--adaptive",
                                    "--interactive-samples", "4"]])
def test_cli_interactive_samples_validation(tmp_path, flags, capsys):
    assert cli.main(["-w", "8", "-H", "8", "-s", "16", "--samples-per-step", "8",
                     "--assets", "constant:1,1,1", "-o", str(tmp_path / "x.png"),
                     "--device", "cpu", *flags]) == 2
    assert "error:" in capsys.readouterr().err
