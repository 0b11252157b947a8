"""The megastep kernel's plain version (ops/megastep.py) against the JAX package.

The plain megastep is held to the reference composition that
tests/test_megastep.py::_xla_twin holds the Pallas megastep to (trace
twin + equirect + nif_apply + bgr flip, summed over samples), with that
test's tolerance: fewer than 0.5% of lanes with a flipped path length,
and on the rest median relative error < 5e-3, max < 8e-2 (scale-floored).
The interpret-mode Pallas megastep is not re-run here: it is the slowest
kernel to emulate, and the twin is what it is held to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_megastep import MAXLEN, SAMPLES, H, W, _setup, _xla_twin

from ipu_path_trace_tpu.models.nif import make_params, make_synthetic_nif
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.models.nif import params_from_jax
from ipu_path_trace_tpu_torch.ops import megastep, nif, trace
from ipu_path_trace_tpu_torch.render.params import RenderSettings


def assert_matches_twin(rad, plen, ref_rad, ref_plen):
    flipped = np.asarray(plen) != ref_plen
    assert flipped.mean() < 5e-3, f"{flipped.sum()} flipped lanes"
    ok = ~flipped
    scale = np.abs(ref_rad).max()
    rel = (np.abs(np.asarray(rad) - ref_rad) / (np.abs(ref_rad) + 1e-2 * scale))[:, ok]
    assert np.median(rel) < 5e-3
    assert rel.max() < 8e-2


def _port_setup(hidden=64, **settings_kw):
    scene, cfg, settings, params, cols, rows, noise = _setup(hidden=hidden)
    if settings_kw:
        settings = settings._replace(**{k: jnp.float32(v) for k, v in settings_kw.items()})
    ref_rad, ref_plen = _xla_twin(scene, cfg, settings, params, cols, rows, noise)
    port_settings = RenderSettings.make(samples_per_step=SAMPLES, **settings_kw)
    return (params_from_jax(params), port_settings, torch.from_numpy(np.array(cols)),
            torch.from_numpy(np.array(rows)), torch.from_numpy(noise), ref_rad, ref_plen)


@pytest.mark.parametrize("hidden,settings_kw", [
    (64, {}),
    ([64, 32, 48], {}),  # mixed widths: the skip layer is re-detected from shapes
    (64, dict(aperture=0.08, focal_distance=3.2)),  # thin lens
])
def test_plain_megastep_matches_reference_composition(hidden, settings_kw):
    model, settings, cols, rows, noise, ref_rad, ref_plen = _port_setup(hidden, **settings_kw)
    before = megastep.render_megastep.launches
    out = megastep.render_megastep(default_scene(), settings, model, cols, rows, noise=noise,
                                   width=W, height=H, max_path_length=MAXLEN)
    assert megastep.render_megastep.launches == before  # CPU: the plain version
    assert_matches_twin(out.radiance.stack().numpy(), out.path_len.numpy(), ref_rad, ref_plen)


def test_hardware_mode_equals_per_sample_composition():
    """The megastep's sample s draws Philox sample s, as the trace kernel
    called with sample_index=s does: fused and per-sample agree exactly."""
    weights, meta = make_synthetic_nif(key=5, hidden=64, num_hidden=3, skip_layer=1)
    model = params_from_jax(make_params(weights, meta, jnp.bfloat16))
    p = W * H
    cols = torch.arange(p, dtype=torch.float32) % W
    rows = torch.div(torch.arange(p), W, rounding_mode="floor").to(torch.float32)
    settings = RenderSettings.make(samples_per_step=2)
    seed = (2024, 77)
    kw = dict(width=W, height=H, max_path_length=MAXLEN)
    out = megastep.render_megastep(default_scene(), settings, model, cols, rows, seed, **kw)
    rad = torch.zeros(3, p)
    plen = torch.zeros(p, dtype=torch.int32)
    for s in range(2):
        st = trace.trace_sample(default_scene(), settings, cols, rows, seed, sample_index=s, **kw)
        env = nif.nif_env_shade(model, st.esc_dir, st.esc_w, settings.azimuth)
        rad += (st.radiance + env).stack()
        plen += st.path_len
    assert torch.equal(out.radiance.stack(), rad)
    assert torch.equal(out.path_len, plen)
    assert rad.abs().sum() > 0


def test_zero_samples():
    model, settings, cols, rows, noise, _, _ = _port_setup()
    out = megastep.render_megastep(default_scene(), settings, model, cols, rows,
                                   noise=noise[:0], width=W, height=H, max_path_length=MAXLEN)
    assert float(out.radiance.stack().abs().max()) == 0.0
    assert int(out.path_len.abs().max()) == 0


@pytest.mark.parametrize("mode", [dict(stub="nif"), dict(stub="trace"), dict(stub="both")])
def test_unported_modes_raise(mode):
    model, settings, cols, rows, noise, _, _ = _port_setup()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        megastep.render_megastep(default_scene(), settings, model, cols, rows, noise=noise,
                                 width=W, height=H, max_path_length=MAXLEN, **mode)
