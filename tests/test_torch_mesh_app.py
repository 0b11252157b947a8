"""The port's app and CLI on a device mesh of CPU shards.

``--device cpu --ipus N`` builds N shards on the CPU, the counterpart of
the reference's virtual CPU mesh: the host film and ``--device-film``
render the same frame on a 4x2 mesh (as they do on one device); the
adaptive step and the Sobol sampler run on it; a render resumed on the
mesh is bit for bit the uninterrupted one (after the JAX package's
tests/test_checkpoint.py::test_resume_on_mesh_bitwise); ``--ipus``
parses as the reference's; the metrics give the chip count and the log
the per-chip rate; ``--device-timing`` times the sharded step; a UI
``interactive_samples`` that does not divide by the sample axis is
refused without ending the render; a NIF hot swap is replicated.
"""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from ipu_path_trace_tpu_torch.film.imageio import read_exr
from ipu_path_trace_tpu_torch.runtime import cli
from ipu_path_trace_tpu_torch.runtime.app import PathTracerApp
from ipu_path_trace_tpu_torch.runtime.config import Config

ROOT = Path(__file__).resolve().parents[1]
NIF = str(ROOT / "assets" / "urban_alley_synth_nif")
NIF_INT8 = str(ROOT / "assets" / "urban_alley_synth_nif_int8")
BASE = ["-w", "16", "-H", "16", "-s", "4", "--samples-per-step", "2", "--max-path-length", "3",
        "--assets", NIF, "--device", "cpu"]
MESH = ["--ipus", "8", "--mesh-shape", "4x2"]


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs files side by side in workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(tmp_path, name, *flags):
    argv = [*BASE, "-o", str(tmp_path / f"{name}.png"), *flags]
    assert cli.main(argv) == 0
    return read_exr(str(tmp_path / f"{name}.exr"))


def test_cli_mesh_host_and_device_film_agree(tmp_path, caplog):
    metrics = tmp_path / "m.jsonl"
    with caplog.at_level(logging.INFO):
        host = _render(tmp_path, "host", *MESH, "--metrics-file", str(metrics))
    dev = _render(tmp_path, "dev", *MESH, "--device-film")
    assert np.isfinite(host).all() and host.max() > 0
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-6)
    summary = json.loads(metrics.read_text().splitlines()[-1])
    assert summary["event"] == "summary" and summary["chips"] == 8
    messages = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Device mesh: {'pixels': 4, 'samples': 2}") for m in messages)
    assert any(m.startswith("Samples/sec/chip: ") for m in messages)


def test_cli_mesh_adaptive_and_sobol(tmp_path):
    adaptive = ["--ipus", "4", "--mesh-shape", "2x2", "--device-film", "--adaptive",
                "--adaptive-min", "1"]
    a = _render(tmp_path, "a", *adaptive)
    b = _render(tmp_path, "b", *adaptive)
    assert np.isfinite(a).all() and a.max() > 0
    np.testing.assert_array_equal(a, b)
    sobol = ["--ipus", "2", "--mesh-shape", "1x2", "--sampler", "sobol", "--sobol-dims", "16"]
    host = _render(tmp_path, "sh", *sobol)
    dev = _render(tmp_path, "sd", *sobol, "--device-film")
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-6)


def _cfg(tmp_path, tag, **kw):
    return Config(**{**dict(assets="constant:0.8,0.7,0.6", width=32, height=24, samples=8,
                            samples_per_step=2, save_interval=2, seed=5, max_path_length=4,
                            device="cpu", ipus=8, mesh_shape="4x2"),
                     "outfile": str(tmp_path / f"{tag}.png"), **kw})


def _run(cfg, max_steps=None):
    app = PathTracerApp(cfg)
    app.init()
    app.build()
    return app.execute(max_steps=max_steps)


@pytest.mark.parametrize("kw", [dict(device_film=True), dict(enable_load_balancing=True)],
                         ids=["device film", "load balancing"])
def test_resume_on_mesh_bitwise(tmp_path, kw):
    """The restored worklist is re-sharded over the mesh (the device film)
    or the re-dealt layouts re-uploaded (the host film): the resumed
    render writes the uninterrupted one's EXR byte for byte."""
    full = _cfg(tmp_path, "full", **kw)
    _run(full)
    ck = str(tmp_path / "state.npz")
    _run(_cfg(tmp_path, "a", checkpoint=ck, **kw), max_steps=3)
    resumed = _cfg(tmp_path, "b", resume=ck, **kw)
    _run(resumed)
    assert (Path(resumed.outfile).with_suffix(".exr").read_bytes()
            == Path(full.outfile).with_suffix(".exr").read_bytes())
    with pytest.raises(ValueError, match="does not match"):  # another mesh, other seeds
        _run(_cfg(tmp_path, "c", resume=ck, mesh_shape="8x1", **kw))


def test_ipus_and_mesh_shape_parse():
    cfg = cli.parse_config(["-o", "out.png", "--assets", "constant:1,1,1", "-w", "512", "-H",
                            "384", "-s", "1000", "--samples-per-step", "100", "--ipus", "2"])
    assert cfg.ipus == 2 and cfg.mesh_shape == ""
    cfg = cli.parse_config(["-o", "out.png", "--assets", "constant:1,1,1", *MESH])
    assert cfg.ipus == 8 and cfg.mesh_shape == "4x2"
    with pytest.raises(ValueError, match="must divide by the sample mesh axis"):
        cli.parse_config(["-o", "o.png", "--assets", "constant:1,1,1", "--samples-per-step",
                          "3", *MESH])


def test_device_timing_times_the_sharded_step(tmp_path, caplog):
    with caplog.at_level(logging.INFO):
        _render(tmp_path, "t", "--ipus", "4", "--mesh-shape", "2x2", "--device-timing")
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Device phase timing [")]
    assert len(lines) == 1 and "Mpaths/s/chip" in lines[0] and "nif-env=" in lines[0]
    from ipu_path_trace_tpu_torch.core.records import make_worklist, to_device_batch
    from ipu_path_trace_tpu_torch.core.scene import default_scene
    from ipu_path_trace_tpu_torch.models.envlight import ConstantEnv
    from ipu_path_trace_tpu_torch.parallel.mesh import make_mesh
    from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig
    from ipu_path_trace_tpu_torch.utils.devtime import measure_phases

    mesh = make_mesh(4, "2x2", ["cpu"] * 4)
    split = measure_phases(default_scene(), RenderSettings.make(samples_per_step=1),
                           StaticConfig(width=16, height=16, max_path_length=3),
                           to_device_batch(make_worklist(16, 16), "cpu"), (1, 2),
                           ConstantEnv((1.0, 1.0, 1.0)), reps=1, mesh=mesh)
    assert split["mpaths_per_sec_chip"] == pytest.approx(split["mpaths_per_sec"] / 4)
    assert "trace_ms" not in split  # the unfused standalone split is skipped on a mesh


def _ui_app(tmp_path, **kw):
    app = PathTracerApp(Config(assets=NIF, width=16, height=16, samples=4, samples_per_step=2,
                               max_path_length=3, device="cpu", ipus=2, mesh_shape="1x2",
                               outfile=str(tmp_path / "u.png"), **kw))
    app.init()
    app.build()
    return app


def test_ui_interactive_samples_must_divide_by_the_sample_axis(tmp_path, caplog):
    app = _ui_app(tmp_path)
    with caplog.at_level(logging.WARNING):
        assert app._process_user_input({"interactive_samples": 3}) == "none"
    assert app.state["interactive_samples"] == 8
    assert any("must divide by the sample mesh axis (2)" in r.getMessage()
               for r in caplog.records)
    assert app._process_user_input({"interactive_samples": 4}) == "restart"
    assert app.state["interactive_samples"] == 4


def test_nif_hot_swap_is_replicated(tmp_path):
    app = _ui_app(tmp_path, nif_precision="int8")
    old = app._env_arg.on("cpu").model
    assert app.load_env(NIF_INT8)
    new = app._env_arg.on("cpu").model
    assert new is app.env.model and new is not old
