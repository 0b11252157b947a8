"""The int8 NIF chain of the PyTorch port against the JAX package.

Layers of evidence, as in tests/test_quant.py:

* the quantiser: given the same activation grids, the int8 kernels equal
  the reference's bit for bit and the f32 scales to rtol 1e-6;
* the integer chain: fed the same int8 input, every layer's int32
  accumulators equal the reference's exactly (the plain version's f32
  integer dots are exact below 2^24);
* end to end against the Pallas kernels in interpret mode, with the
  reference's own int8 budgets: the port encodes with the direct sin/cos
  and the TPU kernel with the double-angle recurrence, so a feature next
  to a rounding tie may take a neighbouring int8 code
  (tests/test_quant.py:126-127, 274-276, 332-337).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.core.vecmath import Vec3 as JVec3
from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu.models import quant as jquant
from ipu_path_trace_tpu.ops.nif_pallas import nif_apply_pallas_t, nif_env_shade_pallas, nif_encode
from ipu_path_trace_tpu_torch.core.vecmath import Vec3
from ipu_path_trace_tpu_torch.models import nif, quant
from ipu_path_trace_tpu_torch.ops import nif as nif_ops

INT8_ASSET = "assets/urban_alley_synth_nif_int8"


def _rel(got, ref):
    return np.abs(got - ref) / (np.abs(ref) + 1e-2 * np.abs(ref).max())


def _uv(seed, p):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (2, p)).astype(np.float32)


def _synthetic(skip_layer=2, hidden=64, num_hidden=4, key=7):
    weights, meta = jnif.make_synthetic_nif(key=key, hidden=hidden, num_hidden=num_hidden,
                                            skip_layer=skip_layer)
    meta.log_tone_map = True
    return weights, meta


def _amax(weights, meta, grid=(64, 128)):
    """The reference's lattice calibration, handed to both quantisers."""
    return jquant._f32_chain_activations(
        weights, jquant.calibration_features(meta.embedding_dimension, grid))


def _asset_nif():
    _, meta, weights = jnif.load_nif_assets(INT8_ASSET, jnp.bfloat16)
    with open(f"{INT8_ASSET}/quant_amax.json") as f:
        return weights, meta, json.load(f)["amax"]


@pytest.fixture(scope="module")
def small():
    """A small int8 net with a skip layer: (JAX params, port model)."""
    weights, meta = _synthetic()
    amax = _amax(weights, meta)
    return jquant.quantize_nif(weights, meta, amax=amax), quant.quantize_nif(
        weights, meta, amax=amax)


@pytest.mark.parametrize("case", ["skip", "no-skip", "asset"])
def test_quantize_matches_reference(case):
    if case == "asset":
        weights, meta, amax = _asset_nif()
    else:
        weights, meta = _synthetic(skip_layer=2 if case == "skip" else None)
        amax = _amax(weights, meta)
    ref = jquant.quantize_nif(weights, meta, amax=amax)
    got = quant.quantize_nif(weights, meta, amax=amax)
    assert got.skip_layer == ref.skip_layer
    for a, b in zip(got.kernels, ref.kernels):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.biases + got.mults + [got.mult_skip, got.inv_next],
                    list(ref.biases) + list(ref.mults) + [ref.mult_skip, ref.inv_next]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert got.max == float(np.float32(ref.max)) and got.log_tone_map == bool(ref.log_tone_map)
    np.testing.assert_array_equal(np.asarray(got.mean, np.float32), np.asarray(ref.mean))


def test_quant_params_from_jax_matches_own_quantiser(small):
    jp, own = small
    model = quant.quant_params_from_jax(jp)
    assert isinstance(model, quant.QuantNifModel)
    for a, b in zip(model.kernels + model.biases + model.mults + [model.mult_skip, model.inv_next],
                    own.kernels + own.biases + own.mults + [own.mult_skip, own.inv_next]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (model.max, model.mean, model.log_tone_map) == (own.max, own.mean, own.log_tone_map)


def test_lattice_calibration_tracks_reference():
    """The port calibrates with its own encode on the same lattice: the
    grids agree with the reference's to well under one percent."""
    weights, meta = _synthetic()
    ref = _amax(weights, meta)
    got = quant._f32_chain_activations(weights, quant.calibration_features(
        meta.embedding_dimension, (64, 128)))
    np.testing.assert_allclose(got, ref, rtol=5e-3)


def test_int8_chain_layer_by_layer_exact(small):
    """Fed the reference's int8 input at every layer, the plain chain's
    int32 accumulators equal the reference's exactly, and so do the
    requantised codes and the head's f32 output."""
    import jax

    jp, model = small
    u, v = (jnp.asarray(a) for a in _uv(3, 777))
    feats_j = jnp.clip(jnp.round(nif_encode(u, v, jp.embedding_dim, jnp.float32) * 127.0),
                       -127.0, 127.0).astype(jnp.int8)
    feats_t = torch.from_numpy(np.array(feats_j))
    dn = (((1,), (0,)), ((), ()))
    x = feats_j
    nl = len(jp.kernels)
    for i in range(nl):
        w_t = jp.kernels[i].T
        skip = i == jp.skip_layer
        last = i == nl - 1
        if skip:
            trunk = w_t.shape[1] - feats_j.shape[0]
            ref_acc = [jax.lax.dot_general(w_t[:, :trunk], x, dn, preferred_element_type=jnp.int32),
                       jax.lax.dot_general(w_t[:, trunk:], feats_j, dn,
                                           preferred_element_type=jnp.int32)]
        else:
            ref_acc = [jax.lax.dot_general(w_t, x, dn, preferred_element_type=jnp.int32)]
        x_t = torch.from_numpy(np.array(x))
        w_tt = model.kernels[i].t()
        acc, accf = quant.quant_dots(x_t, feats_t, w_tt, skip)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc[0]))
        if skip:
            np.testing.assert_array_equal(accf.numpy(), np.asarray(ref_acc[1]))
        else:
            assert accf is None
        ref_out = jquant.quant_layer_t(x, feats_j, w_t, jp.biases[i][:, None],
                                       jp.mults[i][:, None], jp.mult_skip[:, None],
                                       jp.inv_next[i], is_last=last, is_skip=skip)
        got = quant.quant_layer_t(x_t, feats_t, w_tt, model.biases[i][:, None],
                                  model.mults[i][:, None], model.mult_skip[:, None],
                                  float(model.inv_next[i]), is_last=last, is_skip=skip)
        if last:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref_out), rtol=1e-6, atol=1e-6)
        else:
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref_out))
        x = ref_out


def test_plain_int_dot_bounds_its_contraction():
    x = torch.zeros((1032, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="exact"):
        quant.quant_dots(x, x, torch.zeros((4, 1032), dtype=torch.int8), False)


def _int8_case(case):
    weights, meta = _synthetic(skip_layer=2 if case == "int8" else None,
                               hidden=64 if case == "int8" else 48,
                               num_hidden=4 if case == "int8" else 3)
    amax = _amax(weights, meta)
    jp = jquant.quantize_nif(weights, meta, amax=amax)
    return jp, quant.quantize_nif(weights, meta, amax=amax)


@pytest.mark.parametrize("case", ["bf16", "bf16-mixed", "int8", "int8-no-skip"])
def test_nif_apply_t_plain_matches_pallas_interpret(case):
    """K4's plain version against nif_apply_pallas_t in interpret mode:
    bf16 to median 5e-3 / max 8e-2, int8 to median 1e-3 / max 8e-2."""
    if case.startswith("bf16"):
        weights, meta = jnif.make_synthetic_nif(
            key=7, hidden=64 if case == "bf16" else [64, 32, 48], num_hidden=3, skip_layer=1)
        jp = jnif.make_params(weights, meta, jnp.bfloat16)
        model = nif.params_from_jax(jp)
        median = 5e-3
    else:
        jp, model = _int8_case(case)
        median = 1e-3
    u, v = _uv(5, 1000)
    ref = np.asarray(nif_apply_pallas_t(jp, jnp.asarray(u), jnp.asarray(v), block_size=256,
                                        interpret=True))
    before = nif_ops.nif_apply_t.launches
    got = nif_ops.nif_apply_t(model, torch.from_numpy(u), torch.from_numpy(v))
    assert nif_ops.nif_apply_t.launches == before  # CPU tensors: the plain version
    assert got.shape == (3, 1000) and got.dtype == torch.float32
    rel = _rel(got.numpy(), ref)
    assert np.median(rel) < median
    assert rel.max() < 8e-2


def test_int8_plain_matches_reference_twin(small):
    """The whole plain int8 forward against models/quant.nif_apply_quant."""
    jp, model = small
    u, v = _uv(9, 2000)
    ref = np.asarray(jquant.nif_apply_quant(jp, jnp.asarray(u), jnp.asarray(v)))
    got = quant.nif_apply_quant(model, torch.from_numpy(u), torch.from_numpy(v)).numpy()
    rel = _rel(got, ref)
    assert np.median(rel) < 1e-3 and rel.max() < 8e-2


def test_int8_env_shade_matches_pallas_interpret(small):
    """The plain int8 env shade against nif_env_shade_pallas (interpret):
    median 1e-3 and max 0.5.  The TPU kernel's equirect runs polynomial
    acos/atan2 (ops/mathx.py), ~7e-7 from the true functions the port
    uses, and the top octaves (x 2^11) carry that across int8 steps on a
    few percent of lanes; so the bound of 1% of lanes above 1e-2 is held
    where the reference's int8 kernel chain (nif_apply_pallas_t) sees the
    port's own (u, v)."""
    jp, model = small
    rng = np.random.default_rng(33)
    p = 700
    d = rng.normal(size=(3, p)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    escaped = rng.uniform(size=p) < 0.8
    d[:, ~escaped] = 0.0
    w = rng.uniform(0.0, 1.0, size=(3, p)).astype(np.float32)
    w[:, ~escaped] = 0.0
    ref = nif_env_shade_pallas(jp, JVec3(*(jnp.asarray(r) for r in d)),
                               JVec3(*(jnp.asarray(r) for r in w)), jnp.float32(0.7),
                               block_size=256, interpret=True)
    ref = np.stack([np.asarray(c) for c in ref])
    esc_dir = Vec3(*(torch.from_numpy(r) for r in d))
    got = nif_ops.nif_env_shade(model, esc_dir, Vec3(*(torch.from_numpy(r) for r in w)),
                                0.7).stack().numpy()
    rel = _rel(got, ref)
    assert np.median(rel) < 1e-3
    assert rel.max() < 0.5
    assert np.all(got[:, ~escaped] == 0.0)
    u, v = (np.asarray(a) for a in nif_ops.equirect_from_dir(esc_dir, 0.7))
    chain = np.asarray(nif_apply_pallas_t(jp, jnp.asarray(u), jnp.asarray(v), block_size=256,
                                          interpret=True))
    rel = _rel(got, w * chain[::-1])
    assert np.median(rel) < 1e-3
    assert (rel > 1e-2).mean() < 0.01
    assert rel.max() < 0.5


def test_int8_megastep_matches_pallas_interpret(small):
    """The plain megastep with the int8 net against the Pallas megastep in
    host-noise interpret mode (tests/test_quant.py's 24x24 set-up)."""
    from ipu_path_trace_tpu.core.records import make_worklist
    from ipu_path_trace_tpu.core.scene import default_scene as jdefault_scene
    from ipu_path_trace_tpu.ops.megastep_pallas import render_megastep_pallas
    from ipu_path_trace_tpu.render.params import RenderSettings as JRenderSettings
    from ipu_path_trace_tpu_torch.core.scene import default_scene
    from ipu_path_trace_tpu_torch.ops import megastep
    from ipu_path_trace_tpu_torch.render.params import RenderSettings

    W = H = 24
    samples, maxlen = 2, 4
    jp, model = small
    work = make_worklist(W, H)
    cols = np.asarray(work["u"], np.float32)
    rows = np.asarray(work["v"], np.float32)
    rng = np.random.default_rng(7)
    p = cols.shape[0]
    noise = rng.uniform(0, 1, size=(samples, 4 + 4 * maxlen, p)).astype(np.float32)
    noise[:, 0:2] = rng.normal(size=(samples, 2, p))
    ref = render_megastep_pallas(
        jdefault_scene(), JRenderSettings.make(samples_per_step=samples), jp,
        jnp.asarray(cols), jnp.asarray(rows), noise=jnp.asarray(noise), width=W, height=H,
        max_path_length=maxlen, block_size=256, interpret=True)
    ref_rad = np.stack([np.asarray(c) for c in ref.radiance])
    before = megastep.render_megastep.launches
    out = megastep.render_megastep(
        default_scene(), RenderSettings.make(samples_per_step=samples), model,
        torch.from_numpy(cols), torch.from_numpy(rows), noise=torch.from_numpy(noise),
        width=W, height=H, max_path_length=maxlen)
    assert megastep.render_megastep.launches == before
    flipped = out.path_len.numpy() != np.asarray(ref.path_len)
    assert flipped.mean() < 5e-3, f"{flipped.sum()} flipped lanes"
    rel = _rel(out.radiance.stack().numpy(), ref_rad)[:, ~flipped]
    assert np.median(rel) < 5e-3
    assert rel.max() < 8e-2


def test_net_struct_int8_layout():
    """The kernel's view of the canonical int8 net: K padded to 32 with
    the skip layer's trunk and feature columns padded separately."""
    weights, meta, amax = _asset_nif()
    model = quant.quantize_nif(weights, meta, amax=amax)
    net = nif_ops.net_struct(model)
    assert (net.int8, net.num_layers, net.embed_dim, net.max_width) == (1, 7, 12, 320)
    assert list(net.skip[:7]) == [0, 0, 0, 1, 0, 0, 0]
    assert list(net.k_trunk[:7]) == [64, 320, 320, 320, 320, 320, 320]
    assert list(net.k_pad[:7]) == [64, 320, 320, 384, 320, 320, 320]
    np.testing.assert_allclose(list(net.inv_next[:6]), [255.0 / a for a in amax], rtol=1e-6)
    ops = nif_ops.quant_kernel_operands(model)
    assert net.w[3] == ops[3][0].data_ptr() and net.mult[3] == ops[3][2].data_ptr()
    assert net.mult_skip == model.mult_skip.data_ptr()
    assert nif_ops.quant_kernel_operands(model)[3][0] is ops[3][0]  # cached per model
    bf16 = nif_ops.net_struct(nif.load_nif_assets("assets/urban_alley_synth_nif")[0])
    assert bf16.int8 == 0 and list(bf16.k_pad[:7]) == [48, 320, 320, 368, 320, 320, 320]


@pytest.mark.parametrize("skip_layer", [2, None])
def test_int8_packing_keeps_every_integer_dot(skip_layer):
    """Zero-padded (out, in) int8 rows: the padded dots equal the layer's
    integer dots exactly, trunk and feature groups apart."""
    weights, meta = _synthetic(skip_layer=skip_layer, hidden=[40, 64, 24, 56])
    model = quant.quantize_nif(weights, meta, amax=[1.0, 2.0, 3.0, 4.0])
    feat = 4 * model.embedding_dim
    rng = np.random.default_rng(13)
    for (fan_in, fan_out, skip), w, (packed, bias, mult, k_trunk, k_pad) in zip(
            model.layer_plan(), model.kernels, nif_ops.quant_kernel_operands(model)):
        assert packed.dtype == torch.int8 and packed.shape == (-(-fan_out // 8) * 8, k_pad)
        assert k_trunk % 32 == 0 and k_pad % 32 == 0
        trunk = fan_in - feat if skip else fan_in
        x = torch.from_numpy(rng.integers(-128, 128, size=(5, fan_in)).astype(np.int64))
        x_pad = torch.zeros(5, k_pad, dtype=torch.int64)
        x_pad[:, :trunk] = x[:, :trunk]
        x_pad[:, k_trunk:k_trunk + fan_in - trunk] = x[:, trunk:]
        got = x_pad @ packed.to(torch.int64).t()
        assert torch.equal(got[:, :fan_out], x @ w.to(torch.int64))
        assert torch.all(got[:, fan_out:] == 0)
        assert bias.dtype == mult.dtype == torch.float32
