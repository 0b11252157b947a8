"""The port's Owen-Sobol sampler (render/qmc.py, the Sobol rows of
render/wavefront.py and of the kernels' plain versions) against the JAX
package.

The integer hashes must agree bit for bit (same words in, same words
out); the noise rows exactly, except the Box-Muller AA pair (atol 1e-6:
log/cos/sin of two libraries); a full-coverage Sobol render step is held
to the reference composition with tests/test_torch_megastep.py's twin
tolerance.  Inputs come from numpy seeds.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_megastep import assert_matches_twin

from ipu_path_trace_tpu.core.records import make_worklist
from ipu_path_trace_tpu.core.records import to_device_batch as jto_device_batch
from ipu_path_trace_tpu.core.scene import default_scene as jdefault_scene
from ipu_path_trace_tpu.models import NifEnv as JNifEnv
from ipu_path_trace_tpu.models.nif import make_params, make_synthetic_nif
from ipu_path_trace_tpu.render import RenderSettings as JRenderSettings
from ipu_path_trace_tpu.render import StaticConfig as JStaticConfig
from ipu_path_trace_tpu.render import _sobol_dirs as j_dirs
from ipu_path_trace_tpu.render import qmc as jqmc
from ipu_path_trace_tpu.render import wavefront as jwave
from ipu_path_trace_tpu_torch.core.records import to_device_batch
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.models.envlight import ConstantEnv, NifEnv
from ipu_path_trace_tpu_torch.models.nif import params_from_jax
from ipu_path_trace_tpu_torch.ops import megastep, trace
from ipu_path_trace_tpu_torch.render import _sobol_dirs, qmc
from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig
from ipu_path_trace_tpu_torch.render.wavefront import (
    QmcCtx,
    make_qmc_ctx,
    render_step,
    sample_noise,
    sobol_dims_used,
)

W, H = 16, 12
KEY = 0xC0FFEE11
CSRC = Path(__file__).resolve().parents[1] / "ipu_path_trace_tpu_torch" / "csrc"


def _words(seed, n=4096):
    return np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)


def test_sobol_dirs_tables_equal():
    assert _sobol_dirs.DIRS == j_dirs.DIRS
    assert qmc.MAX_DIMS == jqmc.MAX_DIMS and qmc.CAMERA_DIMS == jqmc.CAMERA_DIMS


def test_kernel_table_is_the_reversed_dirs():
    """csrc/sobol_dirs.cuh holds render/qmc.py's reversed table."""
    text = (CSRC / "sobol_dirs.cuh").read_text()
    body = text[text.index("kSobolRevDirs"):]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]
    assert words == [v for row in qmc.REV_DIRS for v in row]
    assert f"kSobolMaxDims = {qmc.MAX_DIMS};" in text


@pytest.mark.parametrize("fn", ["reverse_bits32", "lowbias32", "laine_karras",
                                "scrambled_index_word"])
def test_bit_functions_match_jax(fn):
    x = _words(1)
    seeds = _words(2)
    t, j = torch.from_numpy(x.astype(np.int64)), jnp.asarray(x.astype(np.uint32))
    ts, js = torch.from_numpy(seeds.astype(np.int64)), jnp.asarray(seeds.astype(np.uint32))
    args = {"reverse_bits32": ((t,), (j,)), "lowbias32": ((t,), (j,)),
            "laine_karras": ((t, ts), (j, js)), "scrambled_index_word": ((t, ts), (j, js))}[fn]
    got = getattr(qmc, fn)(*args[0]).numpy()
    want = np.asarray(getattr(jqmc, fn)(*args[1])).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_pixel_and_dim_seeds_match_jax():
    pid = np.random.default_rng(3).integers(0, 1 << 31, 4096).astype(np.int32)
    for key in (0, 1, KEY, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            qmc.pixel_seed(torch.from_numpy(pid), key).numpy(),
            np.asarray(jqmc.pixel_seed(jnp.asarray(pid), key)).astype(np.int64))
        for d in range(qmc.MAX_DIMS):
            assert qmc.dim_seed(key, d) == int(jqmc.dim_seed(key, d))


def test_sobol_uniforms_every_dim_match_jax():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 1 << 31, 2048).astype(np.int32)
    pid = rng.integers(0, 1 << 31, 2048).astype(np.int32)
    got = qmc.sobol_uniforms(torch.from_numpy(idx), torch.from_numpy(pid), KEY,
                             range(qmc.MAX_DIMS))
    want = jqmc.sobol_uniforms(jnp.asarray(idx), jnp.asarray(pid), KEY, range(qmc.MAX_DIMS))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ctx(n, seed=5):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, W * H, n).astype(np.int32)
    base = rng.integers(0, 5000, n).astype(np.int32)
    return pid, base


@pytest.mark.parametrize("aa", ["uniform", "normal", "truncated-normal"])
@pytest.mark.parametrize("sobol_dims", [4, 12, 40])
def test_sample_noise_sobol_rows_match_jax(aa, sobol_dims):
    """The Sobol rows of sample_noise equal the reference's: uniform rows
    exactly, the transformed AA pair within 1e-6."""
    n, L = 1500, 9
    pid, base = _ctx(n)
    cfg = StaticConfig(width=W, height=H, max_path_length=L, aa_noise_type=aa,
                       sampler="sobol", sobol_dims=sobol_dims)
    jcfg = JStaticConfig(width=W, height=H, max_path_length=L, aa_noise_type=aa,
                         sampler="sobol", sobol_dims=sobol_dims)
    qd = sobol_dims_used(cfg)
    assert qd == jwave.sobol_dims_used(jcfg)
    ctx = QmcCtx(torch.from_numpy(pid), torch.from_numpy(base), KEY)
    got = sample_noise((11, 12), n, cfg, qmc_ctx=ctx, sample_idx=3).numpy()
    want = np.asarray(jwave.sample_noise(
        jax.random.key(0), n, jcfg, jwave.QmcCtx(jnp.asarray(pid), jnp.asarray(base), KEY), 3))
    assert got.shape == want.shape == (4 + 4 * L, n)
    np.testing.assert_array_equal(got[2:qd], want[2:qd])
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-6)


def test_rows_past_the_prefix_are_the_philox_stream():
    """Past sobol_dims the kernels draw Philox groups as in hardware mode."""
    n, L = 700, 4
    pid, base = _ctx(n)
    cfg = StaticConfig(width=W, height=H, max_path_length=L, sampler="sobol", sobol_dims=8)
    ctx = QmcCtx(torch.from_numpy(pid), torch.from_numpy(base), KEY)
    got = sample_noise((5, 6), n, cfg, qmc_ctx=ctx, sample_idx=2)
    philox = trace.philox_noise((5, 6), 2, n, L, cfg.aa_noise_type, "cpu")
    assert torch.equal(got[8:], philox[8:])
    assert not torch.equal(got[:8], philox[:8])


def _jax_setup(hidden=32):
    weights, meta = make_synthetic_nif(key=5, hidden=hidden, num_hidden=2, skip_layer=1)
    return make_params(weights, meta, jnp.bfloat16)


@pytest.mark.parametrize("fused", [True, False])
def test_plain_sobol_step_matches_reference(fused):
    """At full Sobol coverage (no Philox tail) the port's render step and
    the reference's XLA step consume the same points of the same
    sequences: (pixel id, base = sampleCount, key) agree."""
    L, spp = 3, 2
    params = _jax_setup()
    wl = make_worklist(W, H)
    wl["sampleCount"] = np.random.default_rng(6).integers(0, 300, len(wl)).astype(np.uint16)
    jcfg = JStaticConfig(width=W, height=H, max_path_length=L, sampler="sobol",
                         sobol_dims=4 + 4 * L, use_pallas=False)
    ref = jwave.render_step(jdefault_scene(), JRenderSettings.make(samples_per_step=spp, seed=KEY),
                            jcfg, jto_device_batch(wl), jax.random.key(0), JNifEnv(params=params))
    cfg = StaticConfig(width=W, height=H, max_path_length=L, sampler="sobol",
                       sobol_dims=4 + 4 * L, use_fused_step=fused)
    work = to_device_batch(wl, "cpu")
    out = render_step(default_scene(), RenderSettings.make(samples_per_step=spp, seed=KEY), cfg,
                      work, (1, 2), NifEnv(params_from_jax(params)))
    rad = torch.stack([out.r, out.g, out.b]).numpy()  # the worklist starts at zero
    ref_rad = np.stack([np.asarray(ref.r), np.asarray(ref.g), np.asarray(ref.b)])
    assert_matches_twin(rad, out.path_length.numpy(), ref_rad, np.asarray(ref.path_length))
    np.testing.assert_array_equal(out.sample_count.numpy(), np.asarray(ref.sample_count))


@pytest.mark.parametrize("device_film", [True, False])
def test_two_steps_of_two_equal_one_step_of_four(device_film):
    """Index continuity (tests/test_qmc.py:187 in the port): two Sobol
    steps of 2 draw the same points as one of 4.  With the device film
    the base rides sample_count; with the host film the counts restart
    every step and the caller passes the base."""
    L = 2
    cfg = StaticConfig(width=W, height=H, max_path_length=L, sampler="sobol",
                       sobol_dims=4 + 4 * L, use_fused_step=False)
    env = ConstantEnv((0.9, 0.9, 1.0))
    work0 = to_device_batch(make_worklist(W, H), "cpu")
    two = render_step(default_scene(), RenderSettings.make(samples_per_step=2), cfg, work0,
                      (1, 2), env)
    if device_film:
        two = render_step(default_scene(), RenderSettings.make(samples_per_step=2), cfg, two,
                          (3, 4), env)
    else:
        second = render_step(default_scene(), RenderSettings.make(samples_per_step=2), cfg,
                             work0, (3, 4), env, sobol_base=2)
        two = two._replace(r=two.r + second.r, g=two.g + second.g, b=two.b + second.b,
                           sample_count=two.sample_count + second.sample_count)
    one = render_step(default_scene(), RenderSettings.make(samples_per_step=4), cfg, work0,
                      (1, 2), env)
    assert (two.sample_count == 4).all()
    torch.testing.assert_close(two.r, one.r, rtol=0, atol=1e-4)
    torch.testing.assert_close(two.b, one.b, rtol=0, atol=1e-4)
    assert float(one.r.abs().sum()) > 0


def test_fused_sobol_equals_per_sample_trace():
    """The megastep's Sobol mode draws sample s at base + s, as the trace
    kernel called with sample_index=s does: the plain versions agree
    exactly (a Philox tail included)."""
    L = 3
    params = params_from_jax(_jax_setup())
    cfg = StaticConfig(width=W, height=H, max_path_length=L, sampler="sobol", sobol_dims=8)
    work = to_device_batch(make_worklist(W, H), "cpu")
    work = work._replace(sample_count=work.sample_count + 37)
    settings = RenderSettings.make(samples_per_step=2, seed=KEY)
    fused = render_step(default_scene(), settings, cfg, work, (9, 10), NifEnv(params))
    unfused = render_step(default_scene(), settings, cfg._replace(use_fused_step=False), work,
                          (9, 10), NifEnv(params))
    for a, b in zip(fused, unfused):
        assert torch.equal(a, b)


def test_make_qmc_ctx():
    work = to_device_batch(make_worklist(W, H), "cpu")
    work = work._replace(sample_count=work.sample_count + 5)
    settings = RenderSettings.make(seed=KEY)
    cfg = StaticConfig(width=W, height=H, sampler="sobol")
    assert make_qmc_ctx(work, cfg._replace(sampler="prng"), settings) is None
    ctx = make_qmc_ctx(work, cfg, settings)
    jctx = jwave.make_qmc_ctx(jto_device_batch(make_worklist(W, H)), JStaticConfig(
        width=W, height=H, sampler="sobol"), JRenderSettings.make(seed=KEY))
    np.testing.assert_array_equal(ctx.pixel_id.numpy(), np.asarray(jctx.pixel_id))
    assert (ctx.base == 5).all() and ctx.key == int(jctx.key) == KEY
    assert (make_qmc_ctx(work, cfg, settings, base=16).base == 16).all()


@pytest.mark.parametrize("kwargs,match", [
    (dict(noise=torch.zeros(4 + 4 * 2, 8)), "hardware mode"),
    (dict(seed=(1, 2), sobol_dims=6), "multiple of 4"),
    (dict(seed=(1, 2), sobol_dims=0), "multiple of 4"),
    (dict(seed=(1, 2), sobol_dims=16), "multiple of 4"),
])
def test_trace_rejects_bad_sobol_operands(kwargs, match):
    n = 8
    sob = (torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32), 1)
    cols = torch.zeros(n)
    with pytest.raises(ValueError, match=match):
        trace.trace_sample(default_scene(), RenderSettings.make(), cols, cols,
                           sobol=sob, width=4, height=2, max_path_length=2,
                           **{"sobol_dims": 4, **kwargs})
    with pytest.raises(ValueError, match="sobol_dims needs"):
        megastep.render_megastep(default_scene(), RenderSettings.make(), None, cols, cols,
                                 (1, 2), sobol_dims=4, width=4, height=2, max_path_length=2)
