"""NIF model and env-shade kernel of the PyTorch port against the JAX package.

Tolerances are the reference's own (tests/test_nif_pallas.py): f32
weights to 1e-5 relative (scale-floored) against models/nif.nif_apply,
bf16 weights to median 5e-3 / max 8e-2 relative (bf16 features may round
on opposite sides of an ulp, and the log decode exponentiates the gap),
and the env shade to the same budget against the Pallas kernel run in
interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.core.vecmath import Vec3 as JVec3
from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu.ops.nif_pallas import nif_env_shade_pallas
from ipu_path_trace_tpu_torch.core.vecmath import Vec3
from ipu_path_trace_tpu_torch.models import nif
from ipu_path_trace_tpu_torch.ops import nif as nif_ops

ASSETS = ["assets/urban_alley_synth_nif", "assets/nif_m128-128-80-128-128-128",
          "assets/nif_w192e16"]


def _uv(seed, p=1000):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (2, p)).astype(np.float32)


def _floor_rel(got, ref):
    scale = np.abs(ref).max()
    return np.abs(got - ref) / (np.abs(ref) + 1e-2 * scale)


@pytest.mark.parametrize("asset", ASSETS)
def test_metadata_and_h5_match(asset):
    meta = nif.NifMetaData.load(f"{asset}/nif_metadata.txt")
    jmeta = jnif.NifMetaData.load(f"{asset}/nif_metadata.txt")
    for name in ("embedding_dimension", "name", "image_shape", "eps", "log_tone_map",
                 "max", "hidden_size"):
        assert getattr(meta, name) == getattr(jmeta, name), name
    np.testing.assert_array_equal(meta.mean, jmeta.mean)
    w = nif.NifWeights.load_h5(f"{asset}/converted.hdf5")
    jw = jnif.NifWeights.load_h5(f"{asset}/converted.hdf5")
    assert len(w.layers) == len(jw.layers)
    for a, b in zip(w.layers, jw.layers):
        assert (a.name, a.activation, a.dtype) == (b.name, b.activation, b.dtype)
        np.testing.assert_array_equal(a.kernel, b.kernel)
        np.testing.assert_array_equal(a.bias, b.bias)


@pytest.mark.parametrize("asset", ASSETS)
def test_params_from_jax_matches_loader(asset):
    """params_from_jax(reference params) == the port's own loader, bit for bit."""
    jparams, _, _ = jnif.load_nif_assets(asset, jnp.bfloat16)
    model = nif.params_from_jax(jparams)
    own, _, _ = nif.load_nif_assets(asset, torch.bfloat16)
    assert model.dtype == torch.bfloat16
    for a, b in zip(model.kernels + model.biases, own.kernels + own.biases):
        assert torch.equal(a, b)
    assert (model.max, model.mean, model.log_tone_map) == (own.max, own.mean, own.log_tone_map)


@pytest.mark.parametrize("asset", ASSETS + ["assets/urban_alley_synth_nif_int8"])
def test_hdf5_reader_matches_h5py(asset):
    """The numpy-only HDF5 reader returns what h5py returns: every root
    attribute and every dataset, bit for bit."""
    import h5py

    from ipu_path_trace_tpu_torch.models import hdf5

    ours = hdf5.File(f"{asset}/converted.hdf5")
    with h5py.File(f"{asset}/converted.hdf5", "r") as ref:
        assert {k: str(v) for k, v in ours.attrs.items()} == {
            k: str(v) for k, v in ref.attrs.items()}
        names = []
        ref.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
        assert len(names) == 14
        for name in names:
            got, want = ours["/" + name], ref[name][()]
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError):
        ours["/model_weights/missing"]


def test_layer_plan_detects_skip():
    model, _, _ = nif.load_nif_assets("assets/urban_alley_synth_nif")
    assert model.layer_plan() == [(48, 320, False), (320, 320, False), (320, 320, False),
                                  (368, 320, True), (320, 320, False), (320, 320, False),
                                  (320, 3, False)]
    mixed, _, _ = nif.load_nif_assets("assets/nif_m128-128-80-128-128-128")
    skips = [s for _, _, s in mixed.layer_plan()]
    assert sum(skips) == 1


@pytest.mark.parametrize("skip_layer", [None, 1])
@pytest.mark.parametrize("log_tone_map", [True, False])
def test_nif_apply_f32(skip_layer, log_tone_map):
    weights, meta = jnif.make_synthetic_nif(key=7, hidden=64, num_hidden=3,
                                            skip_layer=skip_layer)
    meta.log_tone_map = log_tone_map
    jp = jnif.make_params(weights, meta, jnp.float32)
    model = nif.params_from_jax(jp)
    assert model.dtype == torch.float32
    u, v = _uv(3)
    ref = np.asarray(jnif.nif_apply(jp, jnp.asarray(u), jnp.asarray(v)))
    got = nif.nif_apply(model, torch.from_numpy(u), torch.from_numpy(v)).numpy()
    assert got.shape == (u.shape[0], 3)
    assert _floor_rel(got, ref).max() < 1e-5


@pytest.mark.parametrize("hidden", [64, [64, 32, 48]])
def test_nif_apply_bf16_synthetic(hidden):
    weights, meta = jnif.make_synthetic_nif(key=7, hidden=hidden, num_hidden=3, skip_layer=1)
    jp = jnif.make_params(weights, meta, jnp.bfloat16)
    model = nif.params_from_jax(jp)
    u, v = _uv(4)
    ref = np.asarray(jnif.nif_apply(jp, jnp.asarray(u), jnp.asarray(v)))
    got = nif.nif_apply(model, torch.from_numpy(u), torch.from_numpy(v)).numpy()
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-6)
    assert np.median(rel) < 5e-3
    assert rel.max() < 8e-2


@pytest.mark.parametrize("asset", ASSETS[:2])
def test_nif_apply_bf16_asset(asset):
    jp, _, _ = jnif.load_nif_assets(asset, jnp.bfloat16)
    model = nif.params_from_jax(jp)
    u, v = _uv(5)
    ref = np.asarray(jnif.nif_apply(jp, jnp.asarray(u), jnp.asarray(v)))
    got = nif.nif_apply(model, torch.from_numpy(u), torch.from_numpy(v)).numpy()
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-6)
    assert np.median(rel) < 5e-3
    assert rel.max() < 8e-2


@pytest.mark.parametrize("kind", ["nif", "constant"])
def test_eval_env_matches_reference(kind):
    """eval_env at (u, v): the NIF (rgb order) within the bf16 budget, a
    constant env exactly."""
    from ipu_path_trace_tpu.models import envlight as jenvlight
    from ipu_path_trace_tpu_torch.models import envlight

    u, v = _uv(6, 500)
    if kind == "nif":
        weights, meta = jnif.make_synthetic_nif(key=3, hidden=64, num_hidden=3, skip_layer=1)
        jp = jnif.make_params(weights, meta, jnp.bfloat16)
        env, jenv = envlight.NifEnv(nif.params_from_jax(jp)), jenvlight.NifEnv(jp)
    else:
        env = envlight.ConstantEnv((0.25, 1.5, 3.0))
        jenv = jenvlight.ConstantEnv(jnp.asarray([0.25, 1.5, 3.0], jnp.float32))
    got = np.stack([c.numpy() for c in envlight.eval_env(env, torch.from_numpy(u),
                                                         torch.from_numpy(v))])
    ref = np.stack([np.asarray(c) for c in jenvlight.eval_env(
        jenv, jnp.asarray(u), jnp.asarray(v), use_pallas=False)])
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-6)
    assert np.median(rel) < 5e-3 and rel.max() < 8e-2
    if kind == "constant":
        np.testing.assert_array_equal(got, ref)


def _escapes(seed, p=700):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, p)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    escaped = rng.uniform(size=p) < 0.8
    d[:, ~escaped] = 0.0
    w = rng.uniform(0.0, 2.0, size=(3, p)).astype(np.float32)
    w[:, ~escaped] = 0.0
    return d, w


@pytest.mark.parametrize("hidden", [64, [64, 32, 48]])
def test_env_shade_matches_pallas_interpret(hidden):
    """The plain env shade against the reference kernel (interpret mode)."""
    weights, meta = jnif.make_synthetic_nif(key=5, hidden=hidden, num_hidden=3, skip_layer=1)
    jp = jnif.make_params(weights, meta, jnp.bfloat16)
    d, w = _escapes(9)
    azimuth = 0.7
    ref = nif_env_shade_pallas(jp, JVec3(*(jnp.asarray(x) for x in d)),
                               JVec3(*(jnp.asarray(x) for x in w)), jnp.float32(azimuth),
                               block_size=256, interpret=True)
    ref = np.stack([np.asarray(c) for c in ref])
    before = nif_ops.nif_env_shade.launches
    got = nif_ops.nif_env_shade(nif.params_from_jax(jp),
                                Vec3(*(torch.from_numpy(x) for x in d)),
                                Vec3(*(torch.from_numpy(x) for x in w)), azimuth)
    assert nif_ops.nif_env_shade.launches == before  # CPU tensors: plain version
    rel = _floor_rel(np.stack([c.numpy() for c in got]), ref)
    assert np.median(rel) < 5e-3
    assert rel.max() < 8e-2


def test_env_shade_zero_for_non_escaped():
    weights, meta = jnif.make_synthetic_nif(key=5, hidden=64, num_hidden=3)
    model = nif.params_from_jax(jnif.make_params(weights, meta, jnp.bfloat16))
    d, w = _escapes(10)
    got = nif_ops.nif_env_shade_plain(model, Vec3(*(torch.from_numpy(x) for x in d)),
                                      Vec3(*(torch.from_numpy(x) for x in w)), 0.0)
    dead = (d ** 2).sum(axis=0) == 0
    for c in got:
        assert torch.all(c[torch.from_numpy(dead)] == 0)
        assert torch.isfinite(c).all()


def test_net_struct_layout():
    """The kernels' view of the canonical net (a NifWg, the wgmma chain's):
    shapes, skip layer, K-slices and the cached operands' pointers."""
    model, _, _ = nif.load_nif_assets("assets/urban_alley_synth_nif")
    net = nif_ops.wg_struct(model)
    assert (net.num_layers, net.embed_dim, net.log_flag, net.int8) == (7, 12, 1, 0)
    assert list(net.chunks[:7]) == [5, 5, 5, 5, 5, 5, 0]
    assert list(net.in_atoms[:7]) == [0, 5, 5, 5, 5, 5, 5]
    assert list(net.f_atoms[:7]) == [1, 0, 0, 1, 0, 0, 0]
    assert list(net.slice_bytes[:7]) == [40_960] * 6 + [1_024]
    slices, bias = nif_ops.wgmma_operands(model)[3]
    assert net.w[3] == slices.data_ptr() and net.b[3] == bias.data_ptr()
    assert nif_ops.wgmma_operands(model)[3][0] is slices  # cached per model
    f32 = nif_ops.wg_struct(nif.load_nif_assets("assets/urban_alley_synth_nif",
                                                torch.float32)[0])
    assert (f32.tf32, list(f32.in_atoms[:7])) == (1, [0, 10, 10, 10, 10, 10, 10])
    with pytest.raises(ValueError, match="bf16, f32 or int8"):
        nif_ops.wg_struct(nif.load_nif_assets("assets/urban_alley_synth_nif",
                                              torch.float16)[0])


@pytest.mark.parametrize("asset", ASSETS)
def test_packed_operands_keep_every_dot_product(asset):
    """Zero-padded K-slices (the wgmma chain's operands): padded inputs -
    the trunk in the activation slices, the Fourier features in the feature
    slices - times the un-swizzled rows equal the layer's products, skip
    layer included, and the padded outputs give zero."""
    from test_torch_nif_wgmma import _unswizzle

    model, _, _ = nif.load_nif_assets(asset)
    rng = np.random.default_rng(13)
    for lay, w, b, (slices, bias) in zip(nif_ops.wgmma_plan(model)["layers"], model.kernels,
                                         model.biases, nif_ops.wgmma_operands(model)):
        flat = torch.from_numpy(_unswizzle(slices.float().numpy()))
        fan_in, fan_out, trunk = lay["fan_in"], lay["fan_out"], lay["trunk"]
        k_act = 64 * lay["in_atoms"]
        assert flat.shape == (lay["rows"], k_act + 64 * lay["f_atoms"])
        x = torch.from_numpy(rng.normal(size=(5, fan_in)).astype(np.float32))
        x_pad = torch.zeros(5, flat.shape[1])
        x_pad[:, :trunk] = x[:, :trunk]
        x_pad[:, k_act:k_act + fan_in - trunk] = x[:, trunk:]
        got = x_pad @ flat.t()
        torch.testing.assert_close(got[:, :fan_out], x @ w.float(), rtol=1e-5, atol=1e-5)
        assert torch.all(got[:, fan_out:] == 0)
        assert bias.dtype == torch.float32 and torch.equal(bias[:fan_out], b.float())
        assert not bias[fan_out:].any()
