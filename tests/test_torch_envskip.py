"""The reference's dead-block env-skip in the port, and the ``--scene``
loader (core/scenefile.py) against the JAX package.

K3 shades escaping rays only (its escape queue), so the port has no skip
to switch: ``--env-skip`` auto, on and off parse, run no probe and render
the film a run without the flag renders, on the enclosed scene (the
camera inside an emissive diffuse shell: nothing escapes) and on the open
default scene.  The env-skip study's dead-block fraction
(probes/envskip_bench.py) counts the (block, sample) pairs with no
escape.  The scene loader must build the reference's arrays from the
same JSON.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.core.scenefile import scene_from_dict as jscene_from_dict
from ipu_path_trace_tpu_torch.core.records import to_device_batch
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.core.scenefile import load_scene, scene_from_dict
from ipu_path_trace_tpu_torch.ops import nif, trace
from ipu_path_trace_tpu_torch.probes.envskip_bench import dead_block_fraction
from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig
from ipu_path_trace_tpu_torch.runtime import cli
from ipu_path_trace_tpu_torch.runtime.checkpoint import load_checkpoint
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


def _grid(scene):
    wl = coherent_order(create_tracing_jobs(W, H), scene, W, H, 90.0)
    work = to_device_batch(wl, "cpu")
    return work.u.float(), work.v.float()


def test_nothing_escapes_the_enclosed_scene():
    scene = scene_from_dict(ENCLOSED)
    cols, rows = _grid(scene)
    st = trace.trace_sample(scene, RenderSettings.make(), cols, rows, (1, 2), width=W,
                            height=H, max_path_length=MAXLEN)
    assert float(st.esc_w.stack().abs().sum()) == 0.0
    assert float(st.radiance.stack().sum()) > 0


@pytest.mark.parametrize("block", [64, nif.WG_RAYS, 256])
def test_dead_block_fraction(block):
    """1.0 where nothing escapes, under 2% on the open default scene (its
    sky is in nearly every coherent block)."""
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


def _cli_film(tmp_path, scene, *flags) -> np.ndarray:
    """The exit checkpoint's film of a CLI render of ``scene`` at 24x16
    with the alley NIF (2 samples, the fused megastep)."""
    out = tmp_path / "_".join(("run", scene, *flags)).replace("-", "")
    out.mkdir()
    argv = ["-w", str(W), "-H", str(H), "-s", "2", "--samples-per-step", "2",
            "--max-path-length", str(MAXLEN), "--assets", "assets/urban_alley_synth_nif",
            "--device", "cpu", "--checkpoint", str(out / "state.npz"), *flags]
    if scene == "enclosed":
        (out / "enclosed.json").write_text(json.dumps(ENCLOSED))
        argv += ["--scene", str(out / "enclosed.json")]
    argv += ["-o", str(out / "x.png")]
    assert cli.main(argv) == 0
    step, mode, state = load_checkpoint(str(out / "state.npz"), cli.parse_config(argv))
    assert (step, mode) == (1, "hdr")
    return state["hdr"]


_FLAGLESS: dict[str, np.ndarray] = {}  # each scene's film without the flag


@pytest.mark.parametrize("flag", ["auto", "on", "off"])
@pytest.mark.parametrize("scene", ["enclosed", "default"])
def test_cli_env_skip_changes_nothing(tmp_path, caplog, monkeypatch, scene, flag):
    """--env-skip auto, on and off parse, exit 0, trace no probe sample (no
    K1 call, no probe line in the log) and render the flagless run's film."""
    if scene not in _FLAGLESS:
        _FLAGLESS[scene] = _cli_film(tmp_path, scene)
    calls = []
    k1 = trace.trace_sample
    monkeypatch.setattr(trace, "trace_sample", lambda *a, **k: (calls.append(1), k1(*a, **k))[1])
    with caplog.at_level(logging.INFO):
        film = _cli_film(tmp_path, scene, "--env-skip", flag)
    assert calls == []
    assert not any("env-skip" in r.getMessage() or "dead-block" in r.getMessage()
                   for r in caplog.records)
    assert np.array_equal(film, _FLAGLESS[scene])
    assert float(film.max()) > 0


_ARGV = ["-w", "8", "-H", "8", "--device", "cpu", "--assets", "constant:0.5,0.5,0.5",
         "-o", "x.png"]


@pytest.mark.parametrize("flags,value", [([], "auto"), (["--env-skip"], "on"),
                                         (["--env-skip", "off"], "off"),
                                         (["--env-skip", "auto"], "auto")])
def test_env_skip_option_parses(flags, value):
    """The option stays for the command lines and traffic files that set it:
    auto by default, a bare flag is on, and the value reaches Config."""
    cfg = cli.parse_config([*_ARGV, *flags])
    assert cfg.env_skip == value
    cfg.validate()


def test_env_skip_option_refuses_other_values(capsys):
    with pytest.raises(SystemExit):
        cli.parse_config([*_ARGV, "--env-skip", "maybe"])
    assert "--env-skip" in capsys.readouterr().err
    cfg = dataclasses.replace(cli.parse_config(_ARGV), env_skip="maybe")
    with pytest.raises(ValueError, match="unknown --env-skip 'maybe'"):
        cfg.validate()


@pytest.mark.parametrize("where", ["StaticConfig", "render_step", "adaptive_render_step",
                                   "render_megastep", "render_megastep_plain"])
def test_the_step_takes_no_env_skip(where):
    """No layer below the app carries the option: the step's configuration
    and every function from the step down to K3."""
    import inspect

    from ipu_path_trace_tpu_torch.ops import megastep
    from ipu_path_trace_tpu_torch.render import adaptive, wavefront

    fn = {"StaticConfig": StaticConfig, "render_step": wavefront.render_step,
          "adaptive_render_step": adaptive.adaptive_render_step,
          "render_megastep": megastep.render_megastep,
          "render_megastep_plain": megastep.render_megastep_plain}[where]
    names = StaticConfig._fields if fn is StaticConfig else inspect.signature(fn).parameters
    assert "env_skip" not in names and len(names) > 3
