"""Adaptive per-block sampling in the port (render/adaptive.py and the
megastep's budgets and statistics) against the JAX package.

As tests/test_adaptive.py: a budgeted plain megastep must decompose
exactly into per-block runs (budgets only bound the sample loop), full
budgets must equal the unbudgeted run, and the lum^2 statistics must
match per-sample runs (rtol 1e-6, atol 1e-7).  ``compute_budgets`` must
equal the reference's int32 for int32 on the same moments; the radiance
is held to the reference composition per block with
tests/test_torch_megastep.py's twin tolerance.  Inputs come from numpy
seeds, at the reference test's shapes (32x16, L = 3, hidden 32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_megastep import assert_matches_twin

from ipu_path_trace_tpu.core.envmap import equirect_uv
from ipu_path_trace_tpu.core.records import make_worklist
from ipu_path_trace_tpu.core.scene import default_scene as jdefault_scene
from ipu_path_trace_tpu.models.nif import make_params, make_synthetic_nif, nif_apply
from ipu_path_trace_tpu.render import RenderSettings as JRenderSettings
from ipu_path_trace_tpu.render import StaticConfig as JStaticConfig
from ipu_path_trace_tpu.render.adaptive import compute_budgets as jcompute_budgets
from ipu_path_trace_tpu.render.wavefront import trace_sample_with_uniforms
from ipu_path_trace_tpu_torch.core.records import to_device_batch
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.models.envlight import ConstantEnv, NifEnv
from ipu_path_trace_tpu_torch.models.nif import params_from_jax
from ipu_path_trace_tpu_torch.ops import megastep
from ipu_path_trace_tpu_torch.render import adaptive
from ipu_path_trace_tpu_torch.render.adaptive import adaptive_render_step, compute_budgets
from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig

W, H = 32, 16  # 512 records = exactly 2 budget blocks of 256
BLOCK = 256
MAXLEN = 3
S_MAX = 3


def _setup():
    weights, meta = make_synthetic_nif(key=5, hidden=32, num_hidden=2, skip_layer=1)
    params = make_params(weights, meta, jnp.bfloat16)
    work = make_worklist(W, H)
    cols = torch.from_numpy(work["u"].astype(np.float32))
    rows = torch.from_numpy(work["v"].astype(np.float32))
    rng = np.random.default_rng(33)
    p = cols.shape[0]
    noise = rng.uniform(0.0, 1.0, size=(S_MAX, 4 + 4 * MAXLEN, p)).astype(np.float32)
    noise[:, 0:2] = rng.normal(size=(S_MAX, 2, p))
    return params, params_from_jax(params), cols, rows, noise


def _twin(params, cols, rows, noise):
    """The reference composition (tests/test_megastep.py::_xla_twin at
    this file's path length): XLA trace + nif_apply + bgr flip, summed."""
    cfg = JStaticConfig(width=W, height=H, max_path_length=MAXLEN)
    settings = JRenderSettings.make(samples_per_step=noise.shape[0])
    p = cols.shape[0]
    rad = np.zeros((3, p), np.float32)
    plen = np.zeros(p, np.int64)
    for s in range(noise.shape[0]):
        st = trace_sample_with_uniforms(
            jdefault_scene(), settings, cfg, cols, rows, jnp.asarray(noise[s, 0:2]),
            jnp.asarray(noise[s, 2:4]), jnp.asarray(noise[s, 4:].reshape(MAXLEN, 4, p)))
        u, v = equirect_uv(st.esc_dir, settings.azimuth)
        out = nif_apply(params, jnp.where(st.escaped, u, 0.0), jnp.where(st.escaped, v, 0.0))
        rad[0] += np.asarray(st.radiance.x + st.esc_w.x * out[:, 2])
        rad[1] += np.asarray(st.radiance.y + st.esc_w.y * out[:, 1])
        rad[2] += np.asarray(st.radiance.z + st.esc_w.z * out[:, 0])
        plen += np.asarray(st.path_len, np.int64)
    return rad, plen


def _run(model, cols, rows, noise=None, seed=None, spp=S_MAX, **kw):
    return megastep.render_megastep(
        default_scene(), RenderSettings.make(samples_per_step=spp), model, cols, rows, seed,
        noise=None if noise is None else torch.from_numpy(np.ascontiguousarray(noise)),
        width=W, height=H, max_path_length=MAXLEN, budget_block=BLOCK, **kw)


def _budgets(*b):
    return torch.tensor(b, dtype=torch.int32)


def test_budgeted_kernel_decomposes_into_per_block_runs():
    """Host noise: a budgeted run equals per-block runs on noise sliced to
    each block's budget, exactly; and each block's radiance matches the
    reference composition on that noise."""
    params, model, cols, rows, noise = _setup()
    budgets = [2, 1]
    out = _run(model, cols, rows, noise, budgets=_budgets(*budgets))
    for g, b in enumerate(budgets):
        sl = slice(g * BLOCK, (g + 1) * BLOCK)
        ref = _run(model, cols[sl], rows[sl], noise[:b, :, sl])
        assert torch.equal(out.radiance.stack()[:, sl], ref.radiance.stack())
        assert torch.equal(out.path_len[sl], ref.path_len)
        twin_rad, twin_plen = _twin(params, jnp.asarray(cols[sl].numpy()),
                                    jnp.asarray(rows[sl].numpy()), noise[:b, :, sl])
        assert_matches_twin(out.radiance.stack()[:, sl].numpy(), out.path_len[sl].numpy(),
                            twin_rad, twin_plen)


def test_hardware_budgets_decompose_into_per_block_runs():
    """Hardware mode: block g's lanes equal an unbudgeted run of budgets[g]
    samples (the same Philox counters), exactly."""
    _, model, cols, rows, _ = _setup()
    budgets = [1, 4]
    out = _run(model, cols, rows, seed=(8, 9), budgets=_budgets(*budgets), with_stats=True)
    for g, b in enumerate(budgets):
        sl = slice(g * BLOCK, (g + 1) * BLOCK)
        ref = _run(model, cols, rows, seed=(8, 9), spp=b, with_stats=True)
        assert torch.equal(out.radiance.stack()[:, sl], ref.radiance.stack()[:, sl])
        assert torch.equal(out.path_len[sl], ref.path_len[sl])
        assert torch.equal(out.lum2[sl], ref.lum2[sl])


def test_full_budgets_equal_unbudgeted_run():
    _, model, cols, rows, noise = _setup()
    plain = _run(model, cols, rows, noise)
    budgeted = _run(model, cols, rows, noise, budgets=_budgets(S_MAX, S_MAX), with_stats=True)
    assert torch.equal(plain.radiance.stack(), budgeted.radiance.stack())
    assert torch.equal(plain.path_len, budgeted.path_len)
    assert plain.lum2 is None and budgeted.lum2 is not None


def test_lum2_stats_match_per_sample_runs():
    """with_stats sums luminance(sample total)^2 over the samples."""
    _, model, cols, rows, noise = _setup()
    budgets = [1, S_MAX]
    out = _run(model, cols, rows, noise, budgets=_budgets(*budgets), with_stats=True)
    for g, b in enumerate(budgets):
        sl = slice(g * BLOCK, (g + 1) * BLOCK)
        manual = np.zeros(BLOCK, np.float32)
        for s in range(b):
            one = _run(model, cols[sl], rows[sl], noise[s:s + 1, :, sl])
            lum = (megastep.LUM_R * one.radiance.x + megastep.LUM_G * one.radiance.y
                   + megastep.LUM_B * one.radiance.z).numpy()
            manual += lum * lum
        np.testing.assert_allclose(out.lum2[sl].numpy(), manual, rtol=1e-6, atol=1e-7)
    assert float(out.lum2.max()) > 0


@pytest.mark.parametrize("bad", [
    dict(budgets=torch.ones(3, dtype=torch.int32)),  # not one per block
    dict(budgets=torch.ones(2, dtype=torch.int64)),
    dict(budgets=torch.ones(4, dtype=torch.int32), budget_block=128),
])
def test_megastep_rejects_bad_budgets(bad):
    _, model, cols, rows, noise = _setup()
    kw = {"budget_block": BLOCK, **bad}
    with pytest.raises(ValueError, match="budget"):
        megastep.render_megastep(default_scene(), RenderSettings.make(), model, cols, rows,
                                 noise=torch.from_numpy(noise), width=W, height=H,
                                 max_path_length=MAXLEN, **kw)


def _both(r, g, b, lum2, n, **kw):
    got = compute_budgets(*(torch.from_numpy(np.asarray(a)) for a in (r, g, b, lum2)),
                          torch.from_numpy(np.asarray(n, np.int32)), **kw)
    want = jcompute_budgets(*(jnp.asarray(a) for a in (r, g, b, lum2)),
                            jnp.asarray(np.asarray(n, np.int32)), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


@pytest.mark.parametrize("seed", range(4))
def test_compute_budgets_matches_reference_on_random_moments(seed):
    rng = np.random.default_rng(seed)
    p, block = 5000, 256  # a ragged last block
    n = rng.integers(1, 64, p).astype(np.int32)
    r, g, b = (rng.gamma(1.0, 2.0, p).astype(np.float32) * n for _ in range(3))
    lum = (0.2126 * r + 0.7152 * g + 0.0722 * b) / n
    lum2 = (lum * lum * n * rng.uniform(1.0, 3.0, p)).astype(np.float32)
    lum2[:block] = (lum[:block] ** 2 * n[:block]).astype(np.float32)  # a quiet block
    buds = _both(r, g, b, lum2, n, block_size=block, samples_per_step=8, min_spp=2,
                 max_spp=int(seed % 2 and 20 or 128))
    assert buds.min() >= 2 and buds.max() <= 128


def test_compute_budgets_hand_cases():
    """tests/test_adaptive.py's allocations: a zero-variance block floors,
    the surplus goes to the other; the cap clips and survives."""
    block, spp, min_spp = 4, 16, 2
    n = np.full(8, 10, np.float32)
    r = np.full(8, 10.0, np.float32) * 10
    g = b = np.zeros(8, np.float32)
    mean = adaptive.LUM_R * r / 10
    lum2 = ((mean * mean) * 10).astype(np.float32)
    lum2[4:] += 10.0
    buds = _both(r, g, b, lum2, n, block_size=block, samples_per_step=spp, min_spp=min_spp,
                 max_spp=100)
    assert buds[0] == min_spp and buds[1] == 2 * spp - min_spp and buds.sum() == 2 * spp
    capped = _both(r, g, b, lum2, n, block_size=block, samples_per_step=spp, min_spp=min_spp,
                   max_spp=20)
    assert capped[1] == 20 and capped[0] == min_spp


def test_compute_budgets_cold_start_is_uniform():
    z = np.zeros(8, np.float32)
    cold = _both(z, z, z, z, np.zeros(8), block_size=4, samples_per_step=16, min_spp=2,
                 max_spp=100)
    np.testing.assert_array_equal(cold, [16, 16])


SPP = 4  # per-step average of the adaptive runs


def _adaptive_run(model, n_steps, sampler="prng", block=BLOCK):
    cfg = StaticConfig(width=W, height=H, max_path_length=MAXLEN, adaptive_min=1,
                       adaptive_max_factor=2.0, sampler=sampler)
    settings = RenderSettings.make(samples_per_step=SPP)
    work = to_device_batch(make_worklist(W, H), "cpu")
    lum2 = torch.zeros(work.u.shape[0])
    history = []
    for step in range(1, n_steps + 1):
        history.append((work, lum2))
        work, lum2 = adaptive_render_step(default_scene(), settings, cfg, work, lum2,
                                          (7, step), NifEnv(model), block_size=block)
    return work, lum2, history, cfg


def test_adaptive_step_bookkeeping_and_determinism():
    """Counts grow by each record's block budget, which the controller
    replays from the accumulated state; reruns are identical."""
    _, model, *_ = _setup()
    work1, _, _, _ = _adaptive_run(model, 1)
    assert (work1.sample_count == SPP).all()  # cold start is uniform
    work3, lum2_3, history, cfg = _adaptive_run(model, 3)
    expect = torch.zeros_like(work3.sample_count)
    for work, lum2 in history:
        min_spp, cap = adaptive.adaptive_caps(cfg, SPP)
        buds = compute_budgets(work.r, work.g, work.b, lum2, work.sample_count,
                               block_size=BLOCK, samples_per_step=SPP, min_spp=min_spp,
                               max_spp=cap)
        expect += buds.repeat_interleave(BLOCK)
    assert torch.equal(work3.sample_count, expect)
    again, lum2_again, _, _ = _adaptive_run(model, 3)
    for a, b in zip(work3, again):
        assert torch.equal(a, b)
    assert torch.equal(lum2_3, lum2_again)


def test_adaptive_sobol_runs_each_lane_at_its_own_count():
    _, model, *_ = _setup()
    work, lum2, _, _ = _adaptive_run(model, 2, sampler="sobol")
    assert torch.isfinite(torch.stack([work.r, work.g, work.b])).all()
    assert float(lum2.sum()) > 0


def test_adaptive_step_requires_the_fused_nif_megastep():
    work = to_device_batch(make_worklist(W, H), "cpu")
    cfg = StaticConfig(width=W, height=H, max_path_length=MAXLEN)
    lum2 = torch.zeros(work.u.shape[0])
    with pytest.raises(ValueError, match="NIF"):
        adaptive_render_step(default_scene(), RenderSettings.make(samples_per_step=2), cfg,
                             work, lum2, (1, 2), ConstantEnv((1.0, 1.0, 1.0)))
    _, model, *_ = _setup()
    with pytest.raises(ValueError, match="fused"):
        adaptive_render_step(default_scene(), RenderSettings.make(samples_per_step=2),
                             cfg._replace(use_fused_step=False), work, lum2, (1, 2),
                             NifEnv(model))


def test_budget_block_is_the_kernels():
    """The controller reads the kernel's constant (one source)."""
    assert megastep.BUDGET_BLOCK == 2048
    assert megastep.BUDGET_BLOCK % megastep.RAYS_PER_CUDA_BLOCK == 0
    assert adaptive_render_step.__kwdefaults__["block_size"] == megastep.BUDGET_BLOCK
