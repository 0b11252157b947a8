"""The port's turntable (ipu_path_trace_tpu_torch/tools/turntable.py) on the CPU.

Mirrors tests/test_ui.py::test_turntable_animation (3 frames, 32x32,
mjpeg: a parseable MP4 of three JPEG samples that differ as the env
rotates), and holds the azimuth schedule to the reference script's: the
env rotation each frame's RenderSettings gets, recorded from both
scripts' runs.
"""

import os
import sys
from pathlib import Path

import pytest

from ipu_path_trace_tpu_torch.render import params as port_params
from ipu_path_trace_tpu_torch.tools import turntable
from ipu_path_trace_tpu_torch.ui.video import iter_mp4_samples

REPO = Path(__file__).resolve().parents[1]
SKY = "texture:" + str(REPO / "assets" / "procedural_sky.exr")


def test_turntable_animation(tmp_path):
    out = str(tmp_path / "tt.mp4")
    res = turntable.render_turntable(width=32, height=32, spp=4, frames=3, fps=8, assets=SKY,
                                     outfile=out, codec="mjpeg", device="cpu")
    data = open(out, "rb").read()
    samples = list(iter_mp4_samples(data))
    assert len(samples) == 3 and res["frames"] == 3 and res["bytes"] == len(data)
    assert all(s[:2] == b"\xff\xd8" for s in samples)  # a JPEG per sample
    assert samples[0] != samples[1] != samples[2]  # the env visibly rotates
    assert res["codec"] == "mjpeg/fmp4" and res["seconds_per_frame"] > 0


def test_turntable_cli_nif(tmp_path):
    """The module's entry point with a NIF env, two frames."""
    out = tmp_path / "nif.mp4"
    assert turntable.main(["--assets", str(REPO / "assets" / "urban_alley_synth_nif"), "-w", "16",
                           "-H", "12", "--spp", "2", "--frames", "2", "--codec", "mjpeg",
                           "--device", "cpu", "-o", str(out)]) == 0
    assert len(list(iter_mp4_samples(out.read_bytes()))) == 2


@pytest.mark.parametrize("frames", [3, 7])
def test_azimuth_schedule_matches_reference(tmp_path, monkeypatch, frames):
    """Both scripts give frame i the same env rotation (degrees)."""
    from ipu_path_trace_tpu import render as jrender

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from turntable import render_turntable as jrender_turntable
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))

    seen = {"port": [], "reference": []}

    def recorder(cls, key):
        make = cls.make

        def wrapped(*args, **kw):
            seen[key].append(kw.get("env_rotation_degrees", 0.0))
            return make(*args, **kw)

        return staticmethod(wrapped)

    monkeypatch.setattr(port_params.RenderSettings, "make",
                        recorder(port_params.RenderSettings, "port"))
    monkeypatch.setattr(jrender.RenderSettings, "make",
                        recorder(jrender.RenderSettings, "reference"))
    turntable.render_turntable(8, 8, 1, frames, 8, "constant:0.5,0.5,0.5",
                               outfile=str(tmp_path / "p.mp4"), codec="mjpeg", device="cpu")
    jrender_turntable(8, 8, 1, frames, 8, "constant:0.5,0.5,0.5",
                      outfile=str(tmp_path / "r.mp4"), codec="mjpeg")
    assert seen["port"] == seen["reference"] == turntable.azimuths(frames)
    assert len(seen["port"]) == frames
