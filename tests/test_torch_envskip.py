"""The dead-block env-skip in the port (the megastep's ``env_skip``, the
auto probe ``render/wavefront.dead_block_fraction`` and
``runtime/app.PathTracerApp.resolve_env_skip``) and the ``--scene``
loader (core/scenefile.py), against the JAX package.

As tests/test_megastep.py::test_megastep_env_skip_exact: on the enclosed
scene (the camera inside an emissive diffuse shell: nothing escapes) the
skip must be bit-exact, on the open default scene within 1e-6.  The
scene loader must build the reference's arrays from the same JSON.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.core.scenefile import scene_from_dict as jscene_from_dict
from ipu_path_trace_tpu.models.nif import make_params, make_synthetic_nif
from ipu_path_trace_tpu_torch.core.records import to_device_batch
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.core.scenefile import load_scene, scene_from_dict
from ipu_path_trace_tpu_torch.models.nif import params_from_jax
from ipu_path_trace_tpu_torch.ops import megastep, trace
from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig
from ipu_path_trace_tpu_torch.render.wavefront import dead_block_fraction
from ipu_path_trace_tpu_torch.runtime import cli
from ipu_path_trace_tpu_torch.runtime.worklist import coherent_order, create_tracing_jobs

W, H = 24, 16
MAXLEN = 3
ENCLOSED = {"objects": [
    {"type": "sphere", "center": [0.0, 0.0, 0.0], "radius": 50.0,
     "colour": [0.5, 0.5, 0.5], "material": "diffuse", "emission": [0.2, 0.2, 0.2]},
    {"type": "sphere", "center": [0.0, -0.5, -3.0], "radius": 0.5,
     "colour": [0.8, 0.3, 0.3], "material": "specular"},
]}
MIXED = {"objects": [
    {"type": "disc", "normal": [0.0, 2.0, 0.0], "center": [0.0, -1.0, -4.0], "radius": 3.0,
     "colour": [0.7, 0.7, 0.7]},
    {"type": "sphere", "center": [1.0, 0.0, -4.0], "radius": 0.8, "material": "refractive"},
    {"type": "sphere", "center": [-1.0, 0.2, -5.0], "radius": 1.0, "material": "specular",
     "emission": [0.0, 3.0, 0.0]},
]}


@pytest.mark.parametrize("doc", [ENCLOSED, MIXED], ids=["enclosed", "mixed"])
def test_scene_from_dict_matches_reference(doc):
    got, want = scene_from_dict(doc), jscene_from_dict(doc)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("text,match", [
    ("{not json", "not valid JSON"),
    (json.dumps({"objects": []}), "non-empty 'objects'"),
    (json.dumps({"objects": [{"type": "cone"}]}), "type must be"),
    (json.dumps({"objects": [{"type": "sphere", "center": [0, 0], "radius": 1}]}),
     "center must be"),
])
def test_load_scene_rejects_bad_files(tmp_path, text, match):
    path = tmp_path / "scene.json"
    path.write_text(text)
    with pytest.raises(ValueError, match=match):
        load_scene(str(path))
    with pytest.raises(ValueError, match="cannot be read"):
        load_scene(str(tmp_path / "missing.json"))


def _model():
    weights, meta = make_synthetic_nif(key=5, hidden=32, num_hidden=2, skip_layer=1)
    return params_from_jax(make_params(weights, meta, jnp.bfloat16))


def _grid(scene):
    wl = coherent_order(create_tracing_jobs(W, H), scene, W, H, 90.0)
    work = to_device_batch(wl, "cpu")
    return work.u.float(), work.v.float()


@pytest.mark.parametrize("scene_name,atol", [("enclosed", 0.0), ("default", 1e-6)])
@pytest.mark.parametrize("mode", ["host", "philox"])
def test_env_skip_matches_no_skip(scene_name, atol, mode):
    scene = scene_from_dict(ENCLOSED) if scene_name == "enclosed" else default_scene()
    cols, rows = _grid(scene)
    rng = np.random.default_rng(21)
    noise = rng.uniform(0.0, 1.0, (3, 4 + 4 * MAXLEN, cols.shape[0])).astype(np.float32)
    noise[:, 0:2] = rng.normal(size=(3, 2, cols.shape[0]))
    args = dict(noise=torch.from_numpy(noise)) if mode == "host" else dict(seed=(4, 5))
    outs = [megastep.render_megastep(scene, RenderSettings.make(samples_per_step=3), _model(),
                                     cols, rows, width=W, height=H, max_path_length=MAXLEN,
                                     env_skip=skip, with_stats=True, **args)
            for skip in (False, True)]
    assert torch.equal(outs[0].path_len, outs[1].path_len)
    for a, b in ((outs[0].radiance.stack(), outs[1].radiance.stack()),
                 (outs[0].lum2, outs[1].lum2)):
        torch.testing.assert_close(a, b, rtol=atol, atol=atol)
    assert float(outs[1].radiance.stack().max()) > 0


def test_nothing_escapes_the_enclosed_scene():
    scene = scene_from_dict(ENCLOSED)
    cols, rows = _grid(scene)
    st = trace.trace_sample(scene, RenderSettings.make(), cols, rows, (1, 2), width=W,
                            height=H, max_path_length=MAXLEN)
    assert float(st.esc_w.stack().abs().sum()) == 0.0
    assert float(st.radiance.stack().sum()) > 0


@pytest.mark.parametrize("block", [megastep.ENV_SKIP_TILE_INT8, megastep.ENV_SKIP_TILE_BF16,
                                   256])
def test_dead_block_fraction(block):
    """1.0 where nothing escapes, below the auto threshold on the open
    default scene (its sky is in every coherent block)."""
    cfg = StaticConfig(width=W, height=H, max_path_length=MAXLEN)
    settings = RenderSettings.make()
    enclosed = scene_from_dict(ENCLOSED)
    assert dead_block_fraction(enclosed, settings, cfg, *_grid(enclosed), (1, 2), 2,
                               block) == 1.0
    frac = dead_block_fraction(default_scene(), settings, cfg, *_grid(default_scene()), (1, 2),
                               2, block)
    assert 0.0 <= frac < 0.02


def test_dead_block_fraction_counts_tiles():
    """Tiles of block lanes, the ragged tail padded with non-escapes."""
    scene = default_scene()
    cfg = StaticConfig(width=W, height=H, max_path_length=1)
    cols = torch.tensor([0.0] * 70, dtype=torch.float32)
    rows = torch.tensor([-1000.0] * 70, dtype=torch.float32)  # straight up: every ray escapes
    assert dead_block_fraction(scene, RenderSettings.make(), cfg, cols, rows, (1, 2), 1,
                               64) == 0.0
    cols[:64], rows[:64] = 14.05, 9.74  # onto the mirror sphere: with L = 1 nothing escapes
    assert dead_block_fraction(scene, RenderSettings.make(), cfg, cols, rows, (1, 2), 1,
                               64) == 0.5


def _cli(tmp_path, *flags):
    return cli.main(["-w", str(W), "-H", str(H), "-s", "2", "--samples-per-step", "2",
                     "--max-path-length", str(MAXLEN), "--assets",
                     "assets/urban_alley_synth_nif", "-o", str(tmp_path / "x.png"),
                     "--device", "cpu", *flags])


@pytest.mark.parametrize("scene,resolved", [("enclosed", "on"), ("default", "off")])
def test_cli_env_skip_auto_resolves(tmp_path, caplog, scene, resolved):
    flags = []
    if scene == "enclosed":
        (tmp_path / "enclosed.json").write_text(json.dumps(ENCLOSED))
        flags = ["--scene", str(tmp_path / "enclosed.json")]
    with caplog.at_level(logging.INFO):
        assert _cli(tmp_path, *flags) == 0
    lines = [r.getMessage() for r in caplog.records if "--env-skip auto" in r.getMessage()]
    assert len(lines) == 1 and lines[0].endswith(f"-> {resolved}"), lines


@pytest.mark.parametrize("flag", ["on", "off"])
def test_cli_env_skip_forced_runs_no_probe(tmp_path, caplog, flag):
    with caplog.at_level(logging.INFO):
        assert _cli(tmp_path, "--env-skip", flag) == 0
    assert not any("--env-skip auto" in r.getMessage() for r in caplog.records)
