"""The port's à-trous denoiser, its guides and the device previews
(film/denoise.py, runtime/app.py) against the JAX package on the CPU.

The same seeded inputs go through both packages:
  * ``primary_features``: hit mask exactly, escape (u, v) to 1e-5,
    normals to 1e-4 (sphere normals of the two intersectors), disparity
    to 1e-5; the sky albedo of a constant env exactly, of the bf16 NIF
    (the plain K4 path against ``eval_env(..., use_pallas=False)``, on
    the same (u, v)) within the reference's bf16 budget, median 5e-3 and
    max 8e-2 relative (tests/test_nif_pallas.py);
  * ``denoise_hdr`` at 1, 2 and 4 iterations, clamp on and off: max
    relative error 1e-4 (the two packages sum the same taps in float32);
  * the device previews on the worklist of tests/test_denoise.py:244:
    LDR within 1 code value.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.core.records import make_worklist as jmake_worklist
from ipu_path_trace_tpu.core.records import raster_permutation as jraster_permutation
from ipu_path_trace_tpu.core.records import to_device_batch as jto_device_batch
from ipu_path_trace_tpu.core.scene import default_scene as jdefault_scene
from ipu_path_trace_tpu.film import denoise as jdenoise
from ipu_path_trace_tpu.models import envlight as jenvlight
from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu.runtime import app as japp
from ipu_path_trace_tpu_torch.core.records import raster_permutation, to_device_batch
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.film import denoise
from ipu_path_trace_tpu_torch.models import envlight, nif
from ipu_path_trace_tpu_torch.runtime import app as app_mod
from ipu_path_trace_tpu_torch.runtime import cli

ASSET = "assets/urban_alley_synth_nif"
W, H = 40, 24


def _envs(kind):
    if kind == "constant":
        c = (0.5, 0.25, 0.125)
        return envlight.ConstantEnv(c), jenvlight.ConstantEnv(colour=jnp.asarray(c, jnp.float32))
    jp, _, _ = jnif.load_nif_assets(ASSET, jnp.bfloat16)
    return envlight.NifEnv(nif.params_from_jax(jp)), jenvlight.NifEnv(params=jp)


@pytest.mark.parametrize("kind", ["constant", "nif"])
@pytest.mark.parametrize("fov,rot", [(90.0, 0.0), (70.0, 30.0)])
def test_primary_features_match_reference(kind, fov, rot):
    env, jenv = _envs(kind)
    got = denoise.guides_numpy(denoise.primary_features(
        default_scene(), W, H, math.radians(fov), env=env, azimuth=math.radians(rot),
        max_batch=300))
    ref = jdenoise.primary_features(jdefault_scene(), W, H, math.radians(fov), env=jenv,
                                    azimuth=math.radians(rot), max_batch=300)
    np.testing.assert_array_equal(got["hit"], ref["hit"])
    np.testing.assert_allclose(got["escape_uv"], ref["escape_uv"], atol=1e-5)
    np.testing.assert_allclose(got["normal"], ref["normal"], atol=1e-4)
    np.testing.assert_allclose(got["disparity"], ref["disparity"], atol=1e-5)
    hit = ref["hit"]
    np.testing.assert_array_equal(got["albedo"][hit], ref["albedo"][hit])
    sky_got, sky_ref = got["albedo"][~hit], np.asarray(ref["albedo"])[~hit]
    assert sky_got.size > 0
    if kind == "constant":
        np.testing.assert_array_equal(sky_got, sky_ref)
        return
    # The sky albedo is the env at each package's own escape (u, v), which
    # differ by an ulp or so; a bf16 feature then rounds the other way on
    # a lane now and then and the log decode magnifies it.  So the wiring
    # is held exactly (the port's albedo is its eval_env at its own (u, v))
    # and the NIF to the bf16 budget on the reference's (u, v).
    def sky_env(uv):
        u = torch.from_numpy(np.ascontiguousarray(uv[~hit][:, 0]))
        v = torch.from_numpy(np.ascontiguousarray(uv[~hit][:, 1]))
        return np.stack([c.numpy() for c in envlight.eval_env(env, u, v)], axis=-1)

    np.testing.assert_array_equal(sky_got, sky_env(got["escape_uv"]))
    on_ref_uv = sky_env(np.asarray(ref["escape_uv"]))
    rel = np.abs(on_ref_uv - sky_ref) / (np.abs(sky_ref) + 1e-6)
    assert np.median(rel) < 5e-3 and rel.max() < 8e-2, (np.median(rel), rel.max())


@pytest.fixture(scope="module")
def guides():
    return jdenoise.primary_features(jdefault_scene(), W, H, math.radians(90.0))


@pytest.mark.parametrize("iterations", [1, 2, 4])
@pytest.mark.parametrize("clamp", [0.0, 10.0])
def test_denoise_hdr_matches_reference(guides, iterations, clamp):
    rng = np.random.default_rng(100 + iterations)
    img = (rng.random((H, W, 3)) * 3.0).astype(np.float32)
    img[rng.integers(0, H, 5), rng.integers(0, W, 5)] = 400.0  # fireflies
    ref = jdenoise.denoise_hdr(img, guides, iterations=iterations, firefly_clamp=clamp)
    got = denoise.denoise_hdr(img, guides, iterations=iterations, firefly_clamp=clamp)
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_denoise_hdr_takes_tensor_guides_on_their_device():
    g = denoise.primary_features(default_scene(), 16, 8, math.radians(90.0))
    img = np.random.default_rng(3).random((8, 16, 3)).astype(np.float32)
    a = denoise.denoise_hdr(img, g, iterations=2)
    b = denoise.denoise_hdr(img, denoise.guides_numpy(g), iterations=2, device="cpu")
    np.testing.assert_array_equal(a, b)


def _preview_inputs():
    """The worklist and guides of tests/test_denoise.py:244."""
    w = h = 16
    rng = np.random.default_rng(17)
    wl = jmake_worklist(w, h)
    for c in "rgb":
        wl[c] = rng.random(len(wl)).astype(np.float32) * 4.0
    wl["sampleCount"][:] = 6
    g = {"albedo": (0.5 + rng.random((h, w, 3))).astype(np.float32),
         "normal": np.tile(np.float32([0, 0, 1]), (h, w, 1)),
         "disparity": rng.random((h, w)).astype(np.float32)}
    return w, h, wl, g


@pytest.mark.parametrize("exposure,gamma", [(0.25, 2.2), (-1.0, 1.8)])
def test_device_previews_match_reference(exposure, gamma):
    w, h, wl, g = _preview_inputs()
    jperm = jnp.asarray(jraster_permutation(wl, w, h))
    perm = torch.from_numpy(raster_permutation(wl, w, h).astype(np.int64))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    work = to_device_batch(wl, "cpu")
    ref = np.asarray(japp._device_preview(jto_device_batch(wl), jperm, jnp.float32(exposure),
                                          jnp.float32(gamma), width=w, height=h))
    got = app_mod._device_preview(work, perm, exposure, gamma, width=w, height=h).numpy()
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    ref = np.asarray(japp._device_preview_denoised(
        jto_device_batch(wl), jperm, jnp.float32(exposure), jnp.float32(gamma),
        jnp.asarray(g["albedo"]), jnp.asarray(g["normal"]), jnp.asarray(g["disparity"]),
        jnp.float32(1.0), jnp.float32(10.0), width=w, height=h, iterations=2))
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    got = app_mod._device_preview_denoised(
        work, perm, exposure, gamma, torch.clamp_min(t["albedo"], denoise.ALBEDO_FLOOR),
        t["normal"], t["disparity"], 1.0, 10.0, width=w, height=h, iterations=2).numpy()
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_raster_permutation_rejects_bad_worklists():
    wl = jmake_worklist(4, 2)
    wl["u"][3] = wl["u"][2]  # a duplicate and a missing pixel
    with pytest.raises(ValueError, match="1 missing, 1 duplicated"):
        raster_permutation(wl, 4, 2)


BASE = ["-w", "24", "-H", "16", "-s", "4", "--samples-per-step", "2", "--max-path-length", "3",
        "--assets", "constant:0.6,0.5,0.4", "--device", "cpu"]


@pytest.mark.parametrize("film", [[], ["--device-film"]])
def test_cli_denoise_saves_filtered_image(tmp_path, film):
    """--denoise filters the saved image only: the film stays raw, and the
    EXR equals denoise_hdr of the raw film with the same guides."""
    from ipu_path_trace_tpu_torch.film.imageio import read_exr

    assert cli.main([*BASE, *film, "-o", str(tmp_path / "raw.png")]) == 0
    assert cli.main([*BASE, *film, "-o", str(tmp_path / "dn.png"), "--denoise",
                     "--denoise-iters", "2"]) == 0
    raw = read_exr(str(tmp_path / "raw.exr"))
    dn = read_exr(str(tmp_path / "dn.exr"))
    g = denoise.primary_features(default_scene(), 24, 16, math.radians(90.0),
                                 env=envlight.ConstantEnv((0.6, 0.5, 0.4)))
    np.testing.assert_allclose(dn, denoise.denoise_hdr(raw, g, iterations=2), rtol=1e-5,
                               atol=1e-6)
    assert not np.array_equal(dn, raw)


@pytest.mark.parametrize("flags", [["--denoise-iters", "0"], ["--denoise-iters", "9"],
                                   ["--denoise-sigma", "0"], ["--denoise-clamp", "-1"]])
def test_cli_denoise_validation(tmp_path, flags, capsys):
    assert cli.main([*BASE, "-o", str(tmp_path / "x.png"), *flags]) == 2
    assert "error:" in capsys.readouterr().err
