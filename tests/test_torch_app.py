"""The port's render step, CLI and import hygiene.

``render_step`` (fused megastep and per-sample trace + env shade, host
noise) is held to the reference composition of
tests/test_megastep.py::_xla_twin with that test's tolerance.  The CLI
renders on the CPU only when asked to (--device cpu); without it, on a
machine without CUDA, it raises instead of falling back.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_megastep import MAXLEN, SAMPLES, H, W, _setup, _xla_twin
from test_torch_megastep import assert_matches_twin

from ipu_path_trace_tpu.core.records import make_worklist
from ipu_path_trace_tpu_torch.core.records import to_device_batch
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.film.imageio import read_exr
from ipu_path_trace_tpu_torch.models.envlight import ConstantEnv, NifEnv
from ipu_path_trace_tpu_torch.models.nif import params_from_jax
from ipu_path_trace_tpu_torch.ops import megastep, nif, trace
from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig
from ipu_path_trace_tpu_torch.render.wavefront import render_step, step_noise
from ipu_path_trace_tpu_torch.runtime import app as app_mod
from ipu_path_trace_tpu_torch.runtime import cli


@pytest.mark.parametrize("fused", [True, False])
def test_render_step_matches_reference_composition(fused):
    scene, cfg, settings, params, cols, rows, noise = _setup()
    ref_rad, ref_plen = _xla_twin(scene, cfg, settings, params, cols, rows, noise)
    work = to_device_batch(make_worklist(W, H), "cpu")
    out = render_step(default_scene(), RenderSettings.make(samples_per_step=SAMPLES),
                      StaticConfig(width=W, height=H, max_path_length=MAXLEN,
                                   use_fused_step=fused),
                      work, None, NifEnv(params_from_jax(params)),
                      noise=torch.from_numpy(noise))
    rad = torch.stack([out.r, out.g, out.b]).numpy()
    assert_matches_twin(rad, out.path_length.numpy(), ref_rad, ref_plen)
    assert torch.all(out.sample_count == SAMPLES)
    np.testing.assert_array_equal(out.u.numpy(), work.u.numpy())


def test_render_step_constant_env():
    """A constant env adds esc_w * colour to the trace's radiance."""
    scene, cfg, settings, params, cols, rows, noise = _setup()
    work = to_device_batch(make_worklist(W, H), "cpu")
    colour = (0.5, 1.0, 2.0)
    out = render_step(default_scene(), RenderSettings.make(samples_per_step=SAMPLES),
                      StaticConfig(width=W, height=H, max_path_length=MAXLEN), work, None,
                      ConstantEnv(colour), noise=torch.from_numpy(noise))
    expect = torch.zeros(3, W * H)
    for s in range(SAMPLES):
        st = trace.trace_sample(default_scene(), RenderSettings.make(samples_per_step=SAMPLES),
                                work.u.float(), work.v.float(), noise=torch.from_numpy(noise[s]),
                                width=W, height=H, max_path_length=MAXLEN)
        expect += st.radiance.stack() + st.esc_w.stack() * torch.tensor(colour)[:, None]
    torch.testing.assert_close(torch.stack([out.r, out.g, out.b]), expect)


@pytest.mark.parametrize("aa", ["uniform", "normal", "truncated-normal"])
def test_step_noise_layout(aa):
    """(S, 4 + 4L, P) host noise from a generator: reproducible, jitter
    rows distributed, every other row a uniform in [0, 1)."""
    cfg = StaticConfig(width=W, height=H, max_path_length=MAXLEN, aa_noise_type=aa)
    a = step_noise(torch.Generator().manual_seed(5), 20_000, cfg, 2)
    b = step_noise(torch.Generator().manual_seed(5), 20_000, cfg, 2)
    assert a.shape == (2, 4 + 4 * MAXLEN, 20_000) and a.dtype == torch.float32
    assert torch.equal(a, b)
    uniforms = a[:, 2:]
    assert uniforms.min() >= 0.0 and uniforms.max() < 1.0
    assert abs(float(uniforms.mean()) - 0.5) < 0.01
    jitter = a[:, :2]
    assert abs(float(jitter.mean())) < 0.02
    assert float(jitter.abs().max()) <= (1.0 if aa == "uniform" else
                                         3.0 if aa == "truncated-normal" else 10.0)


def test_fused_and_unfused_steps_agree_on_generator_noise():
    """Both render_step paths consume step_noise identically."""
    cfg = StaticConfig(width=W, height=H, max_path_length=MAXLEN)
    noise = step_noise(torch.Generator().manual_seed(9), W * H, cfg, 2)
    _, _, _, params, _, _, _ = _setup()
    env = NifEnv(params_from_jax(params))
    work = to_device_batch(make_worklist(W, H), "cpu")
    settings = RenderSettings.make(samples_per_step=2)
    fused = render_step(default_scene(), settings, cfg, work, None, env, noise=noise)
    unfused = render_step(default_scene(), settings, cfg._replace(use_fused_step=False),
                          work, None, env, noise=noise)
    for a, b in zip(fused, unfused):
        assert torch.equal(a, b)


@pytest.mark.parametrize("field,value", [("use_pallas", False), ("pallas_interpret", 2)])
def test_render_step_rejects_unported_config(field, value):
    work = to_device_batch(make_worklist(4, 4), "cpu")
    cfg = StaticConfig(width=4, height=4, max_path_length=2)._replace(**{field: value})
    with pytest.raises(ValueError, match=r"is refused: .*\(ROADMAP\.md queue 1 item 20\)"):
        render_step(default_scene(), RenderSettings.make(samples_per_step=1), cfg, work,
                    (1, 2), ConstantEnv((1.0, 1.0, 1.0)))


@pytest.mark.parametrize("fused", [True, False])
def test_cli_cpu_render(tmp_path, monkeypatch, fused):
    """16x16, two steps on the CPU: PNG and EXR written and finite, and
    every step's records carry samples-per-step samples."""
    fetched = []
    original = app_mod.from_device_batch

    def spy(batch):
        records = original(batch)
        fetched.append(records.copy())  # the host task clears the buffer after the film
        return records

    monkeypatch.setattr(app_mod, "from_device_batch", spy)
    out = tmp_path / "render.png"
    launches = (trace.trace_sample.launches, nif.nif_env_shade.launches,
                megastep.render_megastep.launches)
    rc = cli.main(["-w", "16", "-H", "16", "-s", "4", "--samples-per-step", "2",
                   "--max-path-length", "4", "--assets", "assets/urban_alley_synth_nif",
                   "-o", str(out), "--device", "cpu"],
                  use_fused_step=fused)
    assert rc == 0
    assert out.exists() and out.stat().st_size > 0
    hdr = read_exr(str(tmp_path / "render.exr"))
    assert hdr.shape == (16, 16, 3) and np.isfinite(hdr).all() and hdr.max() > 0
    assert len(fetched) == 2
    for records in fetched:
        real = records["u"] < 16
        assert real.sum() == 256
        assert (records["sampleCount"][real] == 2).all()
        assert (records["pathLength"][real] >= 2).all()
    # CPU tensors never launch a kernel:
    assert launches == (trace.trace_sample.launches, nif.nif_env_shade.launches,
                        megastep.render_megastep.launches)


def test_cli_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the check is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-w", "8", "-H", "8", "-s", "1", "--samples-per-step", "1",
                  "--assets", "constant:1,1,1", "-o", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("flag,msg", [
    (["--mesh-shape", "3x2", "--ipus", "4"], "mesh-shape 3x2 needs 6 devices but 4 requested"),
    (["--mesh-shape", "2"], "mesh-shape must be 'PIXELSxSAMPLES', got '2'"),
], ids=["flag0", "flag1"])
def test_cli_unported_flags_name_their_roadmap_item(tmp_path, capsys, flag, msg):
    """--ipus and --mesh-shape are ported (parallel/mesh.py): a mesh shape
    that is malformed or does not multiply to --ipus is refused, with the
    reference's messages, before anything renders."""
    argv = ["-o", str(tmp_path / "x.png"), "--assets", "constant:1,1,1",
            "--device", "cpu", "-w", "4", "-H", "4", "-s", "1", "--samples-per-step", "1"]
    assert cli.main(argv + flag) == 2
    assert msg in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()


def test_cli_defaults_match_reference():
    """The flags the port has keep the reference CLI's names and defaults."""
    from ipu_path_trace_tpu.runtime.cli import build_parser as jbuild_parser

    ours, ref = cli.build_parser(), jbuild_parser()
    ref_defaults = {a.dest: a.default for a in ref._actions}
    ours_dests = {a.dest for a in ours._actions} - {"help", "device"}
    assert ours_dests <= set(ref_defaults)
    assert set(ref_defaults) - {"help"} <= ours_dests  # every reference flag is known
    for a in ours._actions:
        if a.dest in ref_defaults:
            assert a.default == ref_defaults[a.dest], a.dest


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX, nor the
    JAX package, nor PIL, h5py or optax (the GPU host has none: the port's
    previews use its own JPEG coder, its NIF files its own HDF5 reader and
    writer, its trainer torch.optim); the NIF tools are among the modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ipu_path_trace_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "tools = ['models.train_nif', 'models.convert', 'models.hdf5', 'tools.quant_qat',\n"
        "         'probes.quant_ablation', 'probes.train_replay']\n"
        "missing = [t for t in tools if pkg.__name__ + '.' + t not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'ipu_path_trace_tpu', 'PIL', 'h5py', 'optax')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith(pkg.__name__)]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25


BASE = ["-w", "16", "-H", "16", "-s", "4", "--samples-per-step", "2", "--max-path-length", "3",
        "--assets", "assets/urban_alley_synth_nif", "--device", "cpu"]


def _render(tmp_path, name, *flags, spp=4):
    argv = [*BASE, "-o", str(tmp_path / f"{name}.png"), *flags]
    argv[argv.index("-s") + 1] = str(spp)
    assert cli.main(argv) == 0
    return read_exr(str(tmp_path / f"{name}.exr"))


@pytest.mark.parametrize("flags", [
    ["--adaptive"],  # needs --device-film
    ["--sampler", "sobol", "--sobol-dims", "3"],
    ["--scene", "no/such/scene.json"],
    ["--scene", "BAD_JSON"],
    ["--adaptive", "--device-film", "--nif-mode", "baked"],
    ["--adaptive", "--device-film", "--adaptive-min", "0"],
    ["--adaptive", "--device-film", "--adaptive-max-factor", "0.5"],
    ["--adaptive", "--device-film"],  # samples-per-step 2 < --adaptive-min 8
    ["--samples-per-step", "70000"],  # the u16 wire count needs --device-film
    ["--enable-load-balancing", "--device-film"],  # re-deals need host path lengths
    ["--auto-resume"],  # needs --checkpoint
    ["--auto-resume", "--checkpoint", "a.npz", "--resume", "a.npz"],
])
def test_cli_validation_mirrors_reference(tmp_path, flags, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    flags = [str(bad) if f == "BAD_JSON" else f for f in flags]
    assert cli.main([*BASE, "-o", str(tmp_path / "x.png"), *flags]) == 2
    assert "error:" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()


def test_device_film_lifts_the_u16_limit():
    cfg = cli.parse_config([*BASE, "-o", "x.png", "--samples-per-step", "70000",
                            "--device-film"])
    assert cfg.device_film and cfg.samples_per_step == 70000


@pytest.mark.parametrize("fused", [True, False])
def test_cli_device_film_matches_host_film(tmp_path, monkeypatch, fused):
    """Same seeds, same samples: the film rebuilt from the device sums
    equals the host film's step-wise sum; the device film is fetched
    only at save-interval and at the last step."""
    monkeypatch.setattr(cli, "main", lambda argv, _m=cli.main: _m(argv, use_fused_step=fused))
    host = _render(tmp_path, "host", spp=6)
    fetches = []
    original = app_mod.Film.accumulate_soa

    def spy(film, *a):
        fetches.append(film)
        return original(film, *a)

    monkeypatch.setattr(app_mod.Film, "accumulate_soa", spy)
    dev = _render(tmp_path, "dev", "--device-film", "--save-interval", "2", spp=6)
    assert len(fetches) == 2  # steps 2 and 3 of 3
    assert np.isfinite(dev).all() and dev.max() > 0
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-6)


def test_cli_adaptive_device_film_is_deterministic(tmp_path):
    flags = ["--device-film", "--adaptive", "--adaptive-min", "1"]
    a = _render(tmp_path, "a", *flags)
    b = _render(tmp_path, "b", *flags)
    assert np.isfinite(a).all() and a.max() > 0
    np.testing.assert_array_equal(a, b)


def test_cli_sobol_host_and_device_film_agree(tmp_path):
    """--sampler sobol renders the same image with either film, and its
    second step continues the sequences: the 2-step image is not the
    1-step image (the reference's host film restarts them every step)."""
    host = _render(tmp_path, "host", "--sampler", "sobol", "--sobol-dims", "16")
    dev = _render(tmp_path, "dev", "--sampler", "sobol", "--sobol-dims", "16", "--device-film")
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-6)
    one = _render(tmp_path, "one", "--sampler", "sobol", "--sobol-dims", "16", spp=2)
    assert np.abs(host - one).max() > 1e-3


def test_film_reset():
    from ipu_path_trace_tpu_torch.film.film import Film

    film = Film(4, 2)
    film.accumulate_soa(np.array([1]), np.array([1]), np.array([2.0]), np.array([4.0]),
                        np.array([6.0]), np.array([2]))
    assert film.hdr.sum() == 6.0
    film.reset()
    assert film.hdr.shape == (2, 4, 3) and not film.hdr.any()
