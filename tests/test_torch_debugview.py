"""The port's --debug-view save modes (film/debugview.py) against the JAX
package on the CPU.

Every mode of ``debug_view`` on the same guides, ``mean_path_length`` on
the same records and ``debug_ldr`` equal the reference's exactly (the
port's copy is the same NumPy).  Through the CLI, with a constant env
(so nothing in the channel is random), the port's PNGs of the normal,
albedo, depth and escape-uv views equal the JAX CLI's within 1 code
value (the guides of the two packages' intersectors agree to 1e-4);
the path-length view is a mean path length over max-path-length, in
[0.1, 1] for every pixel.
"""

import numpy as np
import pytest
from PIL import Image

from ipu_path_trace_tpu.film import debugview as jdebugview
from ipu_path_trace_tpu.runtime import cli as jcli
from ipu_path_trace_tpu_torch.film import debugview
from ipu_path_trace_tpu_torch.film.imageio import read_exr
from ipu_path_trace_tpu_torch.runtime import cli


def _guides(seed, h=6, w=5):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    return {"normal": n / np.linalg.norm(n, axis=-1, keepdims=True),
            "albedo": (rng.random((h, w, 3)) * 3.0).astype(np.float32),
            "disparity": rng.random((h, w)).astype(np.float32),
            "escape_uv": rng.random((h, w, 2)).astype(np.float32),
            "hit": rng.random((h, w)) < 0.5}


@pytest.mark.parametrize("mode", debugview.DEBUG_VIEWS)
def test_debug_view_modes_match_reference(mode):
    g = _guides(7)
    plm = np.random.default_rng(8).random((6, 5)).astype(np.float32) * 14.0
    got = debugview.debug_view(mode, g, plm, max_path_length=10)
    ref = jdebugview.debug_view(mode, g, plm, max_path_length=10)
    assert got.dtype == np.float32 and got.shape == (6, 5, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(debugview.debug_ldr(got, 2.2), jdebugview.debug_ldr(ref, 2.2))


def test_debug_view_rejects_unknown_and_needs_path_lengths():
    assert debugview.DEBUG_VIEWS == jdebugview.DEBUG_VIEWS
    with pytest.raises(ValueError, match="unknown debug view"):
        debugview.debug_view("radiance", _guides(1))
    with pytest.raises(ValueError, match="path-length"):
        debugview.debug_view("path-length", _guides(1))


def test_mean_path_length_matches_reference():
    rng = np.random.default_rng(9)
    n = 40
    u = rng.integers(0, 8, n).astype(np.uint16)
    v = rng.integers(0, 5, n).astype(np.uint16)
    u[:3] = 0xFFFF  # padding records
    pl = rng.integers(0, 60, n).astype(np.uint16)
    cnt = rng.integers(0, 5, n).astype(np.uint16)  # some records without samples
    got = debugview.mean_path_length(u, v, pl, cnt, 8, 5)
    np.testing.assert_array_equal(got, jdebugview.mean_path_length(u, v, pl, cnt, 8, 5))


ARGS = ["-w", "24", "-H", "16", "-s", "2", "--samples-per-step", "2", "--max-path-length", "4",
        "--assets", "constant:0.6,0.5,0.4", "--seed", "3", "--fov", "75",
        "--env-map-rotation", "20"]


@pytest.mark.parametrize("mode", ["normal", "albedo", "depth", "escape-uv"])
def test_cli_debug_view_matches_reference_cli(tmp_path, mode):
    ours, ref = tmp_path / "ours.png", tmp_path / "ref.png"
    assert cli.main([*ARGS, "-o", str(ours), "--debug-view", mode, "--device", "cpu"]) == 0
    assert jcli.main([*ARGS, "-o", str(ref), "--debug-view", mode]) == 0
    a = np.asarray(Image.open(ours)).astype(int)
    b = np.asarray(Image.open(ref)).astype(int)
    assert a.shape == b.shape == (16, 24, 3)
    assert np.abs(a - b).max() <= 1
    assert len(np.unique(a)) > 1  # a channel, not a blank frame


@pytest.mark.parametrize("film", [[], ["--device-film"]])
def test_cli_debug_view_path_length(tmp_path, film):
    """The accumulator's mean path length per pixel over max-path-length:
    every path pushes at least once per sample, so >= 1/4 here."""
    out = tmp_path / "pl.png"
    assert cli.main([*ARGS, "-o", str(out), "--debug-view", "path-length", "--device", "cpu",
                     *film]) == 0
    img = read_exr(str(tmp_path / "pl.exr"))
    assert img.shape == (16, 24, 3)
    assert img.min() >= 0.25 - 1e-6 and img.max() <= 1.0
    np.testing.assert_array_equal(img[..., 0], img[..., 1])


def test_cli_debug_view_choices(tmp_path):
    with pytest.raises(SystemExit):
        cli.main([*ARGS, "-o", str(tmp_path / "x.png"), "--debug-view", "radiance",
                  "--device", "cpu"])
