"""Turntable animation: orbit the env light, write an MP4.

Port of ``scripts/turntable.py``: renders N frames with the env light's
azimuth swept over 360 degrees (``azimuths``: frame i at 360 i / N, the
reference's schedule) and encodes them through the video layer the
remote UI streams with (ui/video.make_encoder: ffmpeg H.264 when
available, the dependency-free fMP4/MJPEG muxer otherwise; ``--codec
mjpeg`` forces the muxer).  Each frame is one ``render_step`` of
``--spp`` samples on a fresh film, the step seeds drawn from one
generator as the CLI draws them; the azimuth is a runtime field of the
kernels' parameters, so the frames share one build.  On the card unless
``--device cpu`` (the plain versions).

    python -m ipu_path_trace_tpu_torch.tools.turntable [--assets DIR|constant:..|texture:..]
        [--scene FILE] [-w W] [-H H] [--spp N] [--frames N] [--fps N] [--codec auto|mjpeg]
        [--device cuda|cpu] [-o out.mp4]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def azimuths(frames: int) -> list[float]:
    """The env rotation of each frame, in degrees: 360 i / frames."""
    return [360.0 * i / frames for i in range(frames)]


def render_turntable(width: int, height: int, spp: int, frames: int, fps: int, assets: str,
                     scene_path: str = "", exposure: float = 0.0, gamma: float = 2.2,
                     outfile: str = "turntable.mp4", codec: str = "auto",
                     device: str = "cuda") -> dict:
    """Render and encode the orbit; returns the frame count, the bytes
    written, the codec and the seconds per frame (render, fetch, film,
    tone map and encode; the encoder's set-up excluded)."""
    from ..core.records import from_device_batch, make_worklist, to_device_batch
    from ..core.scene import default_scene
    from ..core.scenefile import load_scene
    from ..film.film import Film
    from ..render.params import RenderSettings, StaticConfig
    from ..render.wavefront import render_step
    from ..runtime.app import parse_env_assets, resolve_device, step_seed
    from ..ui.video import Fmp4MjpegEncoder, make_encoder

    dev = resolve_device(device)
    scene = load_scene(scene_path, dev) if scene_path else default_scene(dev)
    env, _ = parse_env_assets(assets, dev)
    cfg = StaticConfig(width=width, height=height)
    work0 = make_worklist(width, height)
    gen = torch.Generator().manual_seed(1)
    enc = Fmp4MjpegEncoder(width, height, fps) if codec == "mjpeg" else make_encoder(
        width, height, fps)
    print(f"encoder: {enc.codec}", file=sys.stderr)
    total = 0
    t0 = time.monotonic()
    with open(outfile, "wb") as f:  # streamed to disk: long animations are not buffered
        for i, azimuth in enumerate(azimuths(frames)):
            settings = RenderSettings.make(samples_per_step=spp, env_rotation_degrees=azimuth)
            out = render_step(scene, settings, cfg, to_device_batch(work0, dev), step_seed(gen),
                              env)
            film = Film(width, height)
            film.accumulate(from_device_batch(out))
            for c in enc.encode(film.ldr(1, exposure, gamma)):
                f.write(c)
                total += len(c)
            if i % 10 == 0:
                print(f"frame {i}/{frames} ({time.monotonic() - t0:.1f}s)", file=sys.stderr)
        for c in enc.close():  # trailing codec output (x264 buffers)
            f.write(c)
            total += len(c)
    secs = time.monotonic() - t0
    print(f"wrote {outfile}: {frames} frames @ {fps} fps, {total / 1e6:.2f} MB, {secs:.1f}s "
          f"({width * height * spp * frames / secs / 1e6:.1f} Msamples/s, "
          f"{secs / max(frames, 1):.3f} s per frame)", file=sys.stderr)
    return {"frames": frames, "bytes": total, "codec": enc.codec,
            "seconds_per_frame": secs / max(frames, 1)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="turntable", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--assets", default="constant:0.9,0.8,0.7")
    p.add_argument("--scene", default="")
    p.add_argument("-w", "--width", type=int, default=384)
    p.add_argument("-H", "--height", type=int, default=384)
    p.add_argument("--spp", type=int, default=256)
    p.add_argument("--frames", type=int, default=96)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--exposure", type=float, default=0.0)
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--codec", default="auto", choices=["auto", "mjpeg"])
    p.add_argument("--device", default="cuda",
                   help="'cuda' runs the CUDA kernels; 'cpu' their plain versions.")
    p.add_argument("-o", "--outfile", default="turntable.mp4")
    a = p.parse_args(argv)
    render_turntable(a.width, a.height, a.spp, a.frames, a.fps, a.assets, a.scene, a.exposure,
                     a.gamma, a.outfile, a.codec, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
