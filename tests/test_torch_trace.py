"""The trace kernel's plain version (ops/trace.py) against the JAX package.

Host-noise mode: the same numpy noise goes through the port's plain trace,
the reference's XLA twin (render/wavefront.trace_sample_with_uniforms) and
the reference's Pallas kernel in interpret mode, with the tolerances of
tests/test_trace_pallas.py (rtol 1e-4, atol 3e-5).  escaped/path_len are
exact on at least 99.5% of lanes; a lane whose tangent ray flips between
hit and miss under another compiler is excluded from the float checks
(the reference's rule, tests/test_megastep.py:79-90).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.core.records import make_worklist
from ipu_path_trace_tpu.core.scene import default_scene as jdefault_scene
from ipu_path_trace_tpu.ops import trace_pallas
from ipu_path_trace_tpu.render.params import RenderSettings as JSettings
from ipu_path_trace_tpu.render.params import StaticConfig as JConfig
from ipu_path_trace_tpu.render.wavefront import trace_sample_with_uniforms as jtrace
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.ops import trace
from ipu_path_trace_tpu_torch.render.params import RenderSettings

W = H = 24
L = 6
SETTINGS = {"pinhole": {}, "dof": dict(aperture=0.3, focal_distance=2.0),
            "wide": dict(fov_degrees=120.0, stop_prob=0.5, roulette_depth=1)}


def _setup(seed=11):
    work = make_worklist(W, H)
    cols = work["u"].astype(np.float32)
    rows = work["v"].astype(np.float32)
    rng = np.random.default_rng(seed)
    p = cols.shape[0]
    noise = rng.uniform(0.0, 1.0, size=(4 + 4 * L, p)).astype(np.float32)
    noise[0:2] = rng.normal(size=(2, p))
    return cols, rows, noise


def _port(cols, rows, noise, **kw):
    return trace.trace_sample(
        default_scene(), RenderSettings.make(samples_per_step=1, **kw),
        torch.from_numpy(cols), torch.from_numpy(rows), noise=torch.from_numpy(noise),
        width=W, height=H, max_path_length=L)


def _check(got, ref, fields=("radiance", "esc_w", "esc_dir")):
    flipped = got.path_len.numpy() != np.asarray(ref.path_len)
    assert flipped.mean() < 5e-3, f"{flipped.sum()} flipped lanes"
    ok = ~flipped
    np.testing.assert_array_equal(got.escaped.numpy()[ok], np.asarray(ref.escaped)[ok])
    for field in fields:
        for c in "xyz":
            np.testing.assert_allclose(
                getattr(getattr(got, field), c).numpy()[ok],
                np.asarray(getattr(getattr(ref, field), c))[ok],
                rtol=1e-4, atol=3e-5, err_msg=f"{field}.{c}")
    return ok


@pytest.mark.parametrize("case", list(SETTINGS))
def test_plain_trace_matches_xla_twin(case):
    cols, rows, noise = _setup()
    got = _port(cols, rows, noise, **SETTINGS[case])
    ref = jtrace(jdefault_scene(), JSettings.make(samples_per_step=1, **SETTINGS[case]),
                 JConfig(width=W, height=H, max_path_length=L), jnp.asarray(cols),
                 jnp.asarray(rows), jnp.asarray(noise[0:2]), jnp.asarray(noise[2:4]),
                 jnp.asarray(noise[4:].reshape(L, 4, -1)))
    ok = _check(got, ref)
    # The default scene exercises escapes, multi-bounce paths and radiance:
    assert got.escaped[torch.from_numpy(ok)].any() and (~got.escaped).any()
    assert int(got.path_len.max()) >= 2


@pytest.mark.parametrize("case,fields", [
    ("pinhole", ("radiance", "esc_w", "esc_dir")),
    # With a lens the reference kernel's raygen rounds differently from
    # its XLA twin; its own DoF test holds radiance only
    # (tests/test_trace_pallas.py:110-115), and so does this one.
    ("dof", ("radiance",)),
])
def test_plain_trace_matches_pallas_interpret(case, fields):
    cols, rows, noise = _setup(12)
    got = _port(cols, rows, noise, **SETTINGS[case])
    ref = trace_pallas.trace_sample_pallas(
        jdefault_scene(), JSettings.make(samples_per_step=1, **SETTINGS[case]),
        jnp.asarray(cols), jnp.asarray(rows), noise=jnp.asarray(noise),
        width=W, height=H, max_path_length=L, block_size=256, interpret=True)
    _check(got, ref, fields)


def test_pack_scene_matches_reference():
    sph, dsc = trace.pack_scene(default_scene())
    jsph, jdsc = trace_pallas.pack_scene(jdefault_scene())
    np.testing.assert_array_equal(sph.numpy(), np.asarray(jsph).reshape(-1))
    np.testing.assert_array_equal(dsc.numpy(), np.asarray(jdsc).reshape(-1))


@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expect):
    """The host Philox4x32-10 (which the CUDA kernels mirror) against the
    published Random123 known-answer vectors."""
    words = trace.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in ctr], *key)
    assert tuple(int(w) for w in words) == expect


@pytest.mark.parametrize("aa", ["uniform", "normal", "truncated-normal"])
def test_philox_noise_layout_and_moments(aa):
    n = 50_000
    noise = trace.philox_noise((7, 9), 3, n, 2, aa, "cpu").numpy()
    assert noise.shape == (12, n)
    u = noise[2:]
    assert u.min() > 0.0 and u.max() <= 1.0  # 24-bit uniforms in (0, 1]
    assert np.abs(u.mean(axis=1) - 0.5).max() < 0.01
    jit = noise[0:2]
    std = {"uniform": 1 / np.sqrt(3), "normal": 1.0, "truncated-normal": 0.99}[aa]
    assert np.abs(jit.mean(axis=1)).max() < 0.02
    assert np.abs(jit.std(axis=1) - std).max() < 0.02
    assert not np.array_equal(noise, trace.philox_noise((7, 9), 4, n, 2, aa, "cpu").numpy())


def test_hardware_mode_is_the_philox_stream():
    """seed= mode traces exactly what host noise from philox_noise gives:
    the stream the CUDA kernels draw in-kernel, per (lane, sample)."""
    cols, rows, _ = _setup()
    seed, s = (123, 456), 2
    noise = trace.philox_noise(seed, s, cols.shape[0], L, "normal", "cpu")
    settings = RenderSettings.make(samples_per_step=1)
    a = trace.trace_sample(default_scene(), settings, torch.from_numpy(cols),
                           torch.from_numpy(rows), seed, sample_index=s,
                           width=W, height=H, max_path_length=L)
    b = trace.trace_sample(default_scene(), settings, torch.from_numpy(cols),
                           torch.from_numpy(rows), noise=noise, width=W, height=H,
                           max_path_length=L)
    for x, y in zip(a, b):
        for u, v in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            assert torch.equal(u, v)


def test_wrapper_dispatch_by_device():
    """CPU tensors take the plain version (no launch); a tensor on any
    other non-CUDA device raises instead of falling back."""
    cols, rows, noise = _setup()
    before = trace.trace_sample.launches
    _port(cols, rows, noise)
    assert trace.trace_sample.launches == before
    meta = torch.empty(cols.shape[0], device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trace.trace_sample(default_scene(), RenderSettings.make(), meta, meta,
                           noise=torch.empty(4 + 4 * L, cols.shape[0], device="meta"),
                           width=W, height=H, max_path_length=L)
    with pytest.raises(ValueError, match="exactly one"):
        trace.trace_sample(default_scene(), RenderSettings.make(), torch.from_numpy(cols),
                           torch.from_numpy(rows), width=W, height=H, max_path_length=L)


def test_trace_params_fov_matches_reference():
    """The kernel's tan(fov/2) operands round like the plain pixel_to_ray's."""
    prm = trace.trace_params(default_scene(), RenderSettings.make(fov_degrees=75.0),
                             width=1104, height=1000, max_path_length=10,
                             aa_noise_type="truncated-normal", seed=(1, 2**32 + 5),
                             device="cpu")
    half = np.float32(np.deg2rad(75.0)) * np.float32(0.5)
    assert prm.tanfov_x == pytest.approx(float(np.tan(half)), rel=1e-7)
    assert prm.tanfov_y == pytest.approx(
        float(np.tan(np.float32(1000 / 1104) * half)), rel=1e-7)
    assert (prm.aa_type, prm.num_s, prm.num_d, prm.seed0, prm.seed1) == (2, 5, 1, 1, 5)
