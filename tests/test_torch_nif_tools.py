"""The port's NIF tools (tools/nif_width_sweep.py, nif_reference_scale.py,
nif_multienv.py, nif_hard_env_check.py, probes/encode_ab.py) and
models/nif.make_synthetic_nif on the CPU, against the JAX package and its
scripts (loaded with importlib, as tests/test_rmse_artifact.py does).

make_synthetic_nif matches the JAX function in shapes and He scale (it
cannot replay jax.random); parse_arch, psnr_log, make_hard_env and
_old_recurrence equal the scripts'; and each tool's ``main`` at a toy size
writes its JSON (and any asset) under ``--out`` and nothing under
``assets/`` or ``docs/``.  Training runs with torch on one thread.
"""

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu_torch.models import nif
from ipu_path_trace_tpu_torch.probes import encode_ab, quant_psnr
from ipu_path_trace_tpu_torch.tools import (nif_hard_env_check, nif_multienv,
                                            nif_reference_scale, nif_width_sweep)

REPO = pathlib.Path(__file__).parent.parent


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hidden", [320, 384, [256, 128, 208, 256, 128, 128]])
def test_make_synthetic_nif_matches_the_jax_shapes_and_scale(hidden):
    jw, jm = jnif.make_synthetic_nif(key=0, hidden=hidden)
    pw, pm = nif.make_synthetic_nif(torch.Generator().manual_seed(0), hidden=hidden)
    assert [l.kernel.shape for l in pw.layers] == [l.kernel.shape for l in jw.layers]
    assert [l.bias.shape for l in pw.layers] == [l.bias.shape for l in jw.layers]
    assert [(l.name, l.activation, l.dtype) for l in pw.layers] == [
        (l.name, l.activation, l.dtype) for l in jw.layers]
    for l in pw.layers:
        assert l.kernel.dtype == np.float32
        fan_in = l.kernel.shape[0]
        assert abs(l.kernel.std() / np.sqrt(2.0 / fan_in) - 1.0) < 0.1
    assert (pm.embedding_dimension, pm.max, pm.log_tone_map, pm.hidden_size) == (
        jm.embedding_dimension, jm.max, jm.log_tone_map, jm.hidden_size)
    np.testing.assert_array_equal(pm.mean, np.asarray(jm.mean, np.float32))
    # An int seed is a CPU generator's: the same weights.
    again, _ = nif.make_synthetic_nif(0, hidden=hidden)
    assert all(np.array_equal(a.kernel, b.kernel) for a, b in zip(again.layers, pw.layers))
    model = nif.make_params(pw, pm, torch.bfloat16)
    assert model.layer_plan()[3][2]  # the skip layer at 3


def test_parse_arch_and_psnr_log_equal_the_scripts():
    ref = _script("nif_reference_scale")
    for token in ("320", "192e16", "256x8", "128x4e16", "64"):
        assert nif_reference_scale.parse_arch(token) == ref.parse_arch(token)
    sweep = _script("nif_width_sweep")
    rng = np.random.default_rng(4)
    ref_img = rng.lognormal(size=(16, 32, 3)).astype(np.float32)
    img = ref_img * rng.uniform(0.9, 1.1, ref_img.shape).astype(np.float32)
    assert quant_psnr.psnr_log(img, ref_img) == sweep.psnr_log(img, ref_img)


def test_make_hard_env_equals_the_script():
    script = _script("nif_hard_env_check")
    for h, w, seed in ((32, 64, 3), (48, 96, 5)):
        a = nif_hard_env_check.make_hard_env(h, w, seed)
        b = script.make_hard_env(h, w, seed)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_old_recurrence_equals_the_script():
    """The recurrence from the same octave-0 sin and cos is the script's
    bit for bit; the whole encode (each package's own sin and cos, which
    may differ by an ulp at octave 0) within the drift the recurrence grows
    from that ulp over 11 octaves (measured: 2.6e-3 on one value of 24,000)."""
    script = _script("encode_ab")
    rng = np.random.default_rng(8)
    u, v = rng.uniform(0.0, 1.0, (2, 500)).astype(np.float32)
    e = 12
    ref = np.asarray(script._old_recurrence(jnp.asarray(u), jnp.asarray(v), e))
    seeds = ref[[0, e, 2 * e, 3 * e]]  # sin u, sin v, cos u, cos v at octave 0
    su, cu = encode_ab._double_angle(torch.from_numpy(seeds[0]), torch.from_numpy(seeds[2]), e)
    sv, cv = encode_ab._double_angle(torch.from_numpy(seeds[1]), torch.from_numpy(seeds[3]), e)
    np.testing.assert_array_equal(torch.stack(su + sv + cu + cv).numpy(), ref)
    got = encode_ab._old_recurrence(torch.from_numpy(u), torch.from_numpy(v), e).numpy()
    assert got.shape == ref.shape == (4 * e, 500)
    np.testing.assert_allclose(got, ref, atol=1e-2)


def _tree(*dirs):
    return {p: p.stat().st_mtime_ns for d in dirs for p in (REPO / d).rglob("*")}


@pytest.mark.parametrize("tool, argv, files", [
    (nif_width_sweep.main, ["--widths", "64", "--layer-count", "2", "--epochs", "1",
                            "--batch-size", "4096", "--skip-bench"],
     ["nif_widths.json", "nif_l2w64/converted.hdf5", "nif_l2w64/nif_metadata.txt"]),
    (nif_reference_scale.main, ["--archs", "320", "64x2", "--epochs", "1", "--batch-size",
                                "2048", "--env", "synth:urban-alley:32x64:seed7"],
     ["nif_reference_scale.json", "urban_alley_synth_nif/converted.hdf5"]),
    (nif_multienv.main, ["--archs", "320", "64", "--seeds", "13", "--epochs", "1",
                         "--batch-size", "2048", "--size", "32x64"], ["nif_multienv.json"]),
    (nif_hard_env_check.main, ["--widths", "64", "--epochs", "1", "--batch-size", "2048",
                               "--size", "32x64"], ["nif_hard_env.json"]),
    (encode_ab.main, ["--grid", "32x64", "--env", "synth:urban-alley:64x128:seed7"],
     ["encode_ab.json"]),
])
def test_tool_writes_only_under_out(tool, argv, files, tmp_path, one_thread):
    before = _tree("assets", "docs")
    out = tmp_path / "out"
    tool(argv + ["--out", str(out), "--device", "cpu"])
    assert _tree("assets", "docs") == before
    for f in files:
        assert (out / f).is_file(), f
    doc = json.loads((out / files[0]).read_text())
    assert doc
    with pytest.raises(SystemExit):  # --out is required
        tool(argv + ["--device", "cpu"])
