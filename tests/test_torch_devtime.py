"""K3's measurement stubs, --device-timing and the observability flags of
the port (utils/devtime.py, utils/logging.py, utils/tracing.py,
utils/introspect.py, runtime/app.py).

The plain stubs are held to the JAX megastep's own stubs
(``render_megastep_pallas(stub=..., interpret=True)``) on the inputs of
tests/test_megastep.py::_setup, with the tolerance of
tests/test_torch_megastep.py: fewer than 0.5% of lanes with a flipped
path length, on the rest median relative error < 5e-3 and max < 8e-2
(scale-floored).  The stubbed trace leaves nothing to flip or round:
radiance is exactly 0 and every path length S x L.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_megastep import MAXLEN, H, W, _setup
from test_torch_megastep import assert_matches_twin

from ipu_path_trace_tpu.core.records import make_worklist
from ipu_path_trace_tpu.models.nif import make_params, make_synthetic_nif
from ipu_path_trace_tpu.ops.megastep_pallas import render_megastep_pallas
from ipu_path_trace_tpu_torch.core.records import to_device_batch
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.models.envlight import NifEnv
from ipu_path_trace_tpu_torch.models.nif import params_from_jax
from ipu_path_trace_tpu_torch.ops import megastep
from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig
from ipu_path_trace_tpu_torch.render.wavefront import render_step
from ipu_path_trace_tpu_torch.runtime import cli
from ipu_path_trace_tpu_torch.utils import devtime
from ipu_path_trace_tpu_torch.utils.logging import logger

S = 2  # samples of the stub checks (the 'nif' stub traces in full)
BASE = ["-w", "16", "-H", "16", "-s", "4", "--samples-per-step", "2", "--max-path-length", "3",
        "--assets", "assets/urban_alley_synth_nif", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _restore_log_level():
    level = logger().level
    yield
    logger().setLevel(level)


def _synthetic_model():
    weights, meta = make_synthetic_nif(key=5, hidden=64, num_hidden=3)
    return make_params(weights, meta, jnp.bfloat16)


@pytest.mark.parametrize("stub", ["nif", "trace", "both"])
def test_plain_stubs_match_the_jax_kernel(stub):
    scene, cfg, settings, _, cols, rows, noise = _setup()
    params = _synthetic_model()
    noise = noise[:S]
    ref = render_megastep_pallas(scene, settings, params, cols, rows, noise=jnp.asarray(noise),
                                 width=W, height=H, max_path_length=MAXLEN,
                                 aa_noise_type=cfg.aa_noise_type, block_size=256,
                                 interpret=True, stub=stub)
    out = megastep.render_megastep(
        default_scene(), RenderSettings.make(samples_per_step=S), params_from_jax(params),
        torch.from_numpy(np.array(cols)), torch.from_numpy(np.array(rows)),
        noise=torch.from_numpy(noise), width=W, height=H, max_path_length=MAXLEN, stub=stub)
    ref_rad = np.stack([np.asarray(getattr(ref.radiance, c)) for c in "xyz"])
    if stub == "nif":
        assert np.abs(ref_rad).max() > 0
        assert_matches_twin(out.radiance.stack().numpy(), out.path_len.numpy(), ref_rad,
                            np.asarray(ref.path_len))
    else:  # nothing to flip or round: both sides exact
        assert not ref_rad.any() and float(out.radiance.stack().abs().max()) == 0.0
        np.testing.assert_array_equal(out.path_len.numpy(), np.asarray(ref.path_len))
        assert torch.all(out.path_len == S * MAXLEN)


@pytest.mark.parametrize("stub", ["trace", "both"])
def test_stubbed_trace_in_hardware_modes(stub):
    """Philox and Sobol draw uniforms in (0, 1]: every bounce counts."""
    model = params_from_jax(_synthetic_model())
    p = W * H
    cols = torch.arange(p, dtype=torch.float32) % W
    rows = torch.div(torch.arange(p), W, rounding_mode="floor").to(torch.float32)
    kw = dict(width=W, height=H, max_path_length=MAXLEN)
    sobol = (rows.to(torch.int32) * W + cols.to(torch.int32), torch.zeros(p, dtype=torch.int32),
             77)
    for extra in ({}, dict(sobol=sobol, sobol_dims=8)):
        out = megastep.render_megastep(default_scene(), RenderSettings.make(samples_per_step=3),
                                       model, cols, rows, (5, 6), stub=stub, **extra, **kw)
        assert torch.all(out.path_len == 3 * MAXLEN)
        assert float(out.radiance.stack().abs().max()) == 0.0


def test_nif_stub_keeps_the_trace():
    """The 'nif' stub changes the env term only: the path lengths are
    the full kernel's, the radiance of lanes that never escape too."""
    model = params_from_jax(_synthetic_model())
    p = W * H
    cols = torch.arange(p, dtype=torch.float32) % W
    rows = torch.div(torch.arange(p), W, rounding_mode="floor").to(torch.float32)
    kw = dict(width=W, height=H, max_path_length=MAXLEN)
    settings = RenderSettings.make(samples_per_step=2)
    full = megastep.render_megastep(default_scene(), settings, model, cols, rows, (5, 6), **kw)
    stub = megastep.render_megastep(default_scene(), settings, model, cols, rows, (5, 6),
                                    stub="nif", **kw)
    assert torch.equal(full.path_len, stub.path_len)
    assert not torch.equal(full.radiance.stack(), stub.radiance.stack())


def test_unknown_stub_raises():
    model = params_from_jax(_synthetic_model())
    with pytest.raises(ValueError, match="unknown megastep stub"):
        megastep.render_megastep(default_scene(), RenderSettings.make(samples_per_step=1), model,
                                 torch.zeros(4), torch.zeros(4), (1, 2), width=4, height=1,
                                 max_path_length=2, stub="bounce")


def test_render_step_forwards_stub():
    """As tests/test_megastep.py::test_render_step_host_noise_forwards_stub:
    the skeleton differs from the full step only if the stub arrives."""
    _, _, _, _, _, _, noise = _setup()
    env = NifEnv(params_from_jax(_synthetic_model()))
    work = to_device_batch(make_worklist(W, H), "cpu")

    def run(stub):
        cfg = StaticConfig(width=W, height=H, max_path_length=MAXLEN, megastep_stub=stub)
        return render_step(default_scene(), RenderSettings.make(samples_per_step=2), cfg, work,
                           None, env, noise=torch.from_numpy(noise[:2])).r.numpy()

    full = run("")
    assert full.any()
    assert not np.array_equal(full, run("both"))


@pytest.mark.parametrize("fused", [True, False])
def test_measure_phases_cpu(fused):
    env = NifEnv(params_from_jax(_synthetic_model()))
    work = to_device_batch(make_worklist(W, H), "cpu")
    cfg = StaticConfig(width=W, height=H, max_path_length=MAXLEN, use_fused_step=fused)
    split = devtime.measure_phases(default_scene(), RenderSettings.make(samples_per_step=2), cfg,
                                   work, (3, 4), env, reps=1)
    keys = {"env_ms", "trace_ms", "overhead_ms"} if fused else {"env_ms", "trace_ms"}
    assert keys | {"step_ms", "mpaths_per_sec", "device"} == set(split)
    assert split["device"] == "cpu, plain versions"
    assert split["step_ms"] > 0 and np.isfinite(split["mpaths_per_sec"])
    assert all(split[k] >= 0 for k in keys)


def _messages(caplog) -> list[str]:
    return [r.getMessage() for r in caplog.records
            if r.name.startswith("ipu_path_trace_tpu_torch")]


def test_cli_device_timing_logs_split(tmp_path, caplog):
    with caplog.at_level(logging.INFO):
        assert cli.main([*BASE, "-o", str(tmp_path / "x.png"), "--device-timing"]) == 0
    timing = [m for m in _messages(caplog) if "Device phase timing" in m]
    assert len(timing) == 1, _messages(caplog)[:10]
    assert "[cpu, plain versions]" in timing[0]
    assert "step=" in timing[0] and "Mpaths/s" in timing[0] and "nif-env=" in timing[0]


@pytest.mark.parametrize("device_film", [False, True])
def test_cli_metrics_file(tmp_path, device_film):
    """As tests/test_observability.py::test_metrics_file_jsonl: one JSON
    line per step plus a summary, in both film modes."""
    mf = tmp_path / "m.jsonl"
    flags = ["--device-film"] if device_film else []
    assert cli.main([*BASE, "-o", str(tmp_path / "x.png"), "--metrics-file", str(mf),
                     *flags]) == 0
    lines = [json.loads(line) for line in mf.read_text().splitlines()]
    steps = [line for line in lines if "step" in line]
    assert [s["step"] for s in steps] == [1, 2] and all(s["steps"] == 2 for s in steps)
    assert steps[0]["samples_per_sec"] > 0 and steps[0]["spp_per_step"] == 2
    assert ("rays_per_sec" in steps[0]) != device_film
    summary = [line for line in lines if line.get("event") == "summary"]
    assert len(summary) == 1 and summary[0]["total_spp"] == 4 and summary[0]["chips"] == 1
    assert len(lines) == 3


def test_cli_profile_dir_writes_trace(tmp_path):
    prof = tmp_path / "prof"
    assert cli.main([*BASE, "-o", str(tmp_path / "x.png"), "--profile-dir", str(prof)]) == 0
    trace = prof / "trace.json"
    assert trace.stat().st_size > 0
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    for span in ("ipu_render", "accumulate_framebuffers", "save_images"):
        assert f"tpu_path_tracer/{span}" in names


@pytest.mark.parametrize("level", ["debug", "off"])
def test_cli_log_level(tmp_path, caplog, level):
    with caplog.at_level(5):
        assert cli.main([*BASE, "-o", str(tmp_path / "x.png"), "--log-level", level]) == 0
    messages = _messages(caplog)
    if level == "off":
        assert messages == []
    else:
        info = [m for m in messages if m.startswith("Tensor info:")]
        assert any("scene.sphere_center: shape=(5, 3) dtype=torch.float32" in m for m in info)
        assert any("env.model.kernel_0: shape=(48, 320) dtype=torch.bfloat16" in m
                   for m in info)
        assert not any(m.startswith("span ") for m in messages)  # trace level only


def test_trace_channel_spans():
    from ipu_path_trace_tpu_torch.utils.tracing import TraceChannel, trace_span

    chan = TraceChannel("test")
    for _ in range(3):
        with chan.span("a"):
            pass
    with trace_span(chan, "b"):
        pass
    with trace_span(None, "c"):  # no channel: no span
        pass
    report = chan.report()
    assert set(report) == {"a", "b"} and report["a"]["count"] == 3
    assert chan.total("a") == report["a"]["total_s"] >= 0.0 and chan.total("c") == 0.0


def test_tensor_info_of_an_int8_env(caplog):
    """Every buffer of a QuantNifModel is logged, at debug level only."""
    from ipu_path_trace_tpu_torch.models.quant import quantize_nif
    from ipu_path_trace_tpu_torch.models.nif import load_nif_assets
    from ipu_path_trace_tpu_torch.utils.introspect import log_tensor_info
    from ipu_path_trace_tpu_torch.utils.logging import set_log_level

    _, meta, weights = load_nif_assets("assets/urban_alley_synth_nif")
    env = NifEnv(quantize_nif(weights, meta, amax=[1.0] * (len(weights.layers) - 1)))
    with caplog.at_level(logging.DEBUG):
        set_log_level("info")
        log_tensor_info("env", env)
        assert not _messages(caplog)
        set_log_level("debug")
        log_tensor_info("env", env)
    logged = {m.split(":")[1].strip() for m in _messages(caplog)}
    assert logged == {f"env.model.{k}" for k, _ in env.model.named_buffers()}
    assert any(k.startswith("env.model.mult_") for k in logged)
    assert "env.model.inv_next" in logged
