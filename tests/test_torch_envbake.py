"""Texture env, NIF baking and the int8 / baked / texture CLI paths of the port.

The texture lookup is plain PyTorch in both packages (XLA outside any
kernel in the reference), so it is held to rtol 1e-6.  The bake runs the
standalone NIF kernel's plain version on the reference's lattice; it is
held to that plain version at lattice points and to the reference's bake
within the RMSE budget of tests/test_envbake.py.  The bakes here are
small: at the asset's own 2048x4096 the plain chain takes minutes on a
CPU, so the CLI's baked run uses a synthetic NIF asset with a small
``original_image_shape``.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.models import envlight as jenvlight
from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu.models import quant as jquant
from ipu_path_trace_tpu_torch.film.imageio import load_hdr_image, read_exr
from ipu_path_trace_tpu_torch.models import envlight, nif, quant
from ipu_path_trace_tpu_torch.ops import megastep
from ipu_path_trace_tpu_torch.ops import nif as nif_ops
from ipu_path_trace_tpu_torch.ops import trace
from ipu_path_trace_tpu_torch.runtime import app as app_mod
from ipu_path_trace_tpu_torch.runtime import cli


def _jnif(embedding_dim=12, key=3):
    weights, meta = jnif.make_synthetic_nif(key=key, hidden=64, num_hidden=3,
                                            embedding_dim=embedding_dim)
    return weights, meta, jnif.make_params(weights, meta, jnp.bfloat16)


@pytest.mark.parametrize("bilinear", [False, True])
def test_eval_texture_matches_reference(bilinear):
    rng = np.random.default_rng(11)
    tex = rng.uniform(0.0, 4.0, (16, 32, 3)).astype(np.float32)
    u = np.concatenate([rng.uniform(0, 1, 500), [0.0, 1.0, 1.0, 0.0, -0.1, 1.2]]).astype(np.float32)
    v = np.concatenate([rng.uniform(0, 1, 500), [0.0, 1.0, 0.0, 1.0, 0.5, 0.5]]).astype(np.float32)
    ref = jenvlight.eval_env(jenvlight.TextureEnv(jnp.asarray(tex), True if bilinear else None),
                             jnp.asarray(u), jnp.asarray(v))
    got = envlight.eval_env(envlight.TextureEnv(torch.from_numpy(tex), bilinear),
                            torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(got.stack().numpy(), np.stack([np.asarray(c) for c in ref]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_bake_equals_plain_nif_at_lattice(precision):
    """One chunk holding the whole lattice: the texel (r, c) is the plain
    NIF at (r / (h - 1), linspace(0, 1, w)[c]), bgr flipped to rgb."""
    weights, meta, jp = _jnif()
    model = (nif.params_from_jax(jp) if precision == "bf16"
             else quant.quantize_nif(weights, meta, grid=(32, 64)))
    h, w = 24, 40
    baked = envlight.bake_nif_env(envlight.NifEnv(model), h, w, max_batch_size=h * w)
    assert baked.bilinear and baked.texture.shape == (h, w, 3)
    u = (torch.arange(h, dtype=torch.float32) / (h - 1)).repeat_interleave(w)
    v = torch.linspace(0.0, 1.0, w).repeat(h)
    ref = nif_ops.nif_apply_t_plain(model, u, v).flip(0).t().reshape(h, w, 3)
    assert torch.equal(baked.texture, ref)


def test_bake_chunks_honour_max_batch_size(monkeypatch):
    """Chunks of max(1, max_batch_size // width) rows, one NIF-apply call
    each, none larger than max_batch_size; the texture does not depend on
    the chunking."""
    _, _, jp = _jnif()
    model = nif.params_from_jax(jp)
    sizes = []
    original = nif_ops.nif_apply_t_plain

    def spy(m, u, v):
        sizes.append(u.shape[0])
        return original(m, u, v)

    full = envlight.bake_nif_env(envlight.NifEnv(model), 20, 64)
    monkeypatch.setattr(nif_ops, "nif_apply_t_plain", spy)
    chunked = envlight.bake_nif_env(envlight.NifEnv(model), 20, 64, max_batch_size=3 * 64 + 5)
    assert sizes == [3 * 64] * 6 + [2 * 64]
    rowwise = envlight.bake_nif_env(envlight.NifEnv(model), 20, 64, max_batch_size=10)
    assert sizes[7:] == [64] * 20
    for t in (chunked, rowwise):
        torch.testing.assert_close(t.texture, full.texture, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_bake_matches_reference_bake(precision):
    """The port's bake against the reference's (XLA chain, same lattice),
    and the baked lookup against the NIF between texels: RMSE within 2e-2
    of the peak, as tests/test_envbake.py holds the reference."""
    weights, meta, jp = _jnif(embedding_dim=6)
    if precision == "int8":
        amax = jquant._f32_chain_activations(
            weights, jquant.calibration_features(meta.embedding_dimension, (32, 64)))
        jp = jquant.quantize_nif(weights, meta, amax=amax)
        model = quant.quantize_nif(weights, meta, amax=amax)
    else:
        model = nif.params_from_jax(jp)
    h, w = 128, 256
    ref = np.asarray(jenvlight.bake_nif_env(jenvlight.NifEnv(jp), h, w, use_pallas=False).texture)
    baked = envlight.bake_nif_env(envlight.NifEnv(model), h, w)
    scale = np.abs(ref).max()
    assert np.sqrt(np.mean((baked.texture.numpy() - ref) ** 2)) / scale < 2e-2
    rng = np.random.default_rng(5)
    u, v = (torch.from_numpy(rng.uniform(0, 1, 2000).astype(np.float32)) for _ in range(2))
    direct = envlight.eval_env(envlight.NifEnv(model), u, v).stack()
    looked_up = envlight.eval_env(baked, u, v).stack()
    scale = float(direct.abs().max())
    assert float(((looked_up - direct) ** 2).mean().sqrt()) / scale < 2e-2


def test_load_hdr_image_reads_exr_only(tmp_path):
    img = load_hdr_image("assets/procedural_sky.exr")
    np.testing.assert_array_equal(img, read_exr("assets/procedural_sky.exr"))
    assert img.dtype == np.float32 and img.ndim == 3 and img.shape[2] == 3
    (tmp_path / "sky.hdr").write_bytes(b"#?RADIANCE\n")
    with pytest.raises(ValueError, match="OpenEXR"):
        load_hdr_image(str(tmp_path / "sky.hdr"))


def _synthetic_assets(tmp_path, image_shape, sidecar=None):
    from ipu_path_trace_tpu.models.train_nif import save_assets

    weights, meta = jnif.make_synthetic_nif(key=3, hidden=32, num_hidden=2, skip_layer=1)
    meta.image_shape = image_shape
    assets = str(tmp_path / "nif_assets")
    save_assets(assets, weights, meta, ["synthetic"])
    if sidecar is not None:
        with open(f"{assets}/quant_amax.json", "w") as f:
            json.dump({"amax": sidecar}, f)
    return assets


def test_parse_env_assets_int8(tmp_path):
    """int8 with the quant_amax.json sidecar uses its grids; without one
    the grids come from the port's lattice calibration."""
    with_sidecar = _synthetic_assets(tmp_path / "a", (8, 16, 3), sidecar=[2.5, 1.25])
    env, _ = app_mod.parse_env_assets(with_sidecar, torch.device("cpu"), "int8")
    assert isinstance(env.model, quant.QuantNifModel)
    np.testing.assert_allclose(env.model.inv_next.numpy()[:-1], [255.0 / 2.5, 255.0 / 1.25],
                               rtol=1e-6)
    without = _synthetic_assets(tmp_path / "b", (8, 16, 3))
    env, (meta, weights) = app_mod.parse_env_assets(without, torch.device("cpu"), "int8")
    amax = quant._f32_chain_activations(weights, quant.calibration_features(
        meta.embedding_dimension))
    np.testing.assert_allclose(env.model.inv_next.numpy()[:-1], [255.0 / a for a in amax],
                               rtol=1e-6)
    env, _ = app_mod.parse_env_assets(without, torch.device("cpu"))
    assert type(env.model) is nif.NifModel and env.model.dtype == torch.bfloat16


def _launches():
    return (trace.trace_sample.launches, nif_ops.nif_env_shade.launches,
            megastep.render_megastep.launches, nif_ops.nif_apply_t.launches)


def _cli_render(tmp_path, assets, extra, fused=True, w=16, h=12):
    out = tmp_path / "render.png"
    before = _launches()
    rc = cli.main(["-w", str(w), "-H", str(h), "-s", "4", "--samples-per-step", "2",
                   "--max-path-length", "4", "--assets", assets, "-o", str(out),
                   "--device", "cpu", *extra], use_fused_step=fused)
    assert rc == 0 and out.exists() and out.stat().st_size > 0
    assert _launches() == before  # CPU tensors never launch a kernel
    hdr = read_exr(str(tmp_path / "render.exr"))
    assert hdr.shape == (h, w, 3) and np.isfinite(hdr).all() and hdr.max() > 0
    return hdr


@pytest.mark.parametrize("fused", [True, False])
def test_cli_int8_cpu(tmp_path, caplog, fused):
    """--nif-precision int8 on the shipped QAT asset: its sidecar is read,
    and the frame is finite and of the right shape."""
    with caplog.at_level(logging.INFO):
        _cli_render(tmp_path, "assets/urban_alley_synth_nif_int8",
                    ["--nif-precision", "int8"], fused)
    assert "quant_amax.json" in caplog.text


def test_cli_baked_cpu(tmp_path, caplog, monkeypatch):
    """--nif-mode baked bakes at the asset's original_image_shape, in
    --max-nif-batch-size chunks, then renders through the texture env."""
    assets = _synthetic_assets(tmp_path, (20, 40, 3))
    bakes = []
    original = envlight.bake_nif_env

    def spy(env, height, width, max_batch_size):
        tex = original(env, height, width, max_batch_size=max_batch_size)
        bakes.append((height, width, max_batch_size, tex))
        return tex

    monkeypatch.setattr(app_mod, "bake_nif_env", spy)
    with caplog.at_level(logging.INFO):
        _cli_render(tmp_path, assets, ["--nif-mode", "baked", "--max-nif-batch-size", "100"])
    [(height, width, batch, tex)] = bakes
    assert (height, width, batch) == (20, 40, 100) and tex.texture.shape == (20, 40, 3)
    assert "Baked NIF env to 20x40" in caplog.text


@pytest.mark.parametrize("fused", [True, False])
def test_cli_texture_cpu(tmp_path, fused):
    """texture:<file.exr> renders through the texture env on either step path."""
    _cli_render(tmp_path, "texture:assets/procedural_sky.exr", [], fused)


def test_cli_three_flags_parse():
    cfg = cli.parse_config(["-o", "x.png", "--assets", "a", "--nif-precision", "int8",
                            "--nif-mode", "baked", "--max-nif-batch-size", "4096"])
    assert (cfg.nif_precision, cfg.nif_mode, cfg.max_nif_batch_size) == ("int8", "baked", 4096)
    cfg = cli.parse_config(["-o", "x.png", "--assets", "a"])
    assert (cfg.nif_precision, cfg.nif_mode, cfg.max_nif_batch_size) == ("auto", "fused", 44160)
    for bad in (["--nif-precision", "fp4"], ["--nif-mode", "lazy"]):
        with pytest.raises(SystemExit):
            cli.parse_config(["-o", "x.png", "--assets", "a", *bad])
    assert cli.main(["-o", "x.png", "--assets", "a", "--max-nif-batch-size", "0"]) == 2
