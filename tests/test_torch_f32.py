"""The f32 NIF chain (``--partials-type float``) of the port against the JAX package.

On the CPU the port runs the plain f32 chain (models/nif.mlp_chain on f32
weights; on CUDA the kernels run it on TF32 wgmma, csrc/nif_wgmma.cuh
ChainTf32, which chip_smoke.py holds to this plain version).  Held here:

  * the plain K4 (``nif_apply_t``) against the reference's kernel in
    interpret mode, and the plain K2 (``nif_env_shade``) against the
    reference's composition of the same function, at the cases and
    budgets of tests/test_nif_pallas.py:18-90: max |out - ref| / (|ref| +
    1e-2 max|ref|) < 1.5e-2 (2e-2 at E = 16);
  * the plain K3 with f32 weights against the JAX package's composition
    in host-noise mode (tests/test_megastep.py::_xla_twin), at that
    test's flip rule and the f32 budget;
  * the tf32 chain's host side: its shared-memory plan for 4-byte
    operands (the 64-ray tile), the shapes it refuses with the limit
    named, the hi/lo slices (un-swizzled by an independent formula) and a
    CPU model of the kernel's 3xTF32 arithmetic from those slices against
    the reference's f32 nif_apply;
  * ``--partials-type float`` through the port's CLI on the CPU against
    the JAX package's f32 composition on the same host noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_megastep import MAXLEN, _xla_twin

from ipu_path_trace_tpu.core.envmap import equirect_uv as jequirect_uv
from ipu_path_trace_tpu.core.scene import default_scene as jdefault_scene
from ipu_path_trace_tpu.core.vecmath import Vec3 as JVec3
from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu.ops.nif_pallas import nif_apply_pallas
from ipu_path_trace_tpu.render import RenderSettings as JRenderSettings
from ipu_path_trace_tpu.render import StaticConfig as JStaticConfig
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.core.vecmath import Vec3
from ipu_path_trace_tpu_torch.film.imageio import read_exr
from ipu_path_trace_tpu_torch.models import nif
from ipu_path_trace_tpu_torch.ops import megastep
from ipu_path_trace_tpu_torch.ops import nif as nif_ops
from ipu_path_trace_tpu_torch.render.params import RenderSettings
from ipu_path_trace_tpu_torch.runtime import app as app_mod
from ipu_path_trace_tpu_torch.runtime import cli

CANONICAL = "assets/urban_alley_synth_nif"


def _rel(got, ref):
    return np.abs(got - ref) / (np.abs(ref) + 1e-2 * np.abs(ref).max())


def _uv(seed, p):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (2, p)).astype(np.float32)


def _synthetic(key, log_tone_map=True, **kw):
    weights, meta = jnif.make_synthetic_nif(key=key, **kw)
    meta.log_tone_map = log_tone_map
    return jnif.make_params(weights, meta, jnp.float32)


# The cases of tests/test_nif_pallas.py:18-90: (params, uv seed, points, budget).
CASES = {
    **{f"skip{s}-log{int(lt)}": (dict(key=7, hidden=64, num_hidden=3, skip_layer=s,
                                      log_tone_map=lt), 3, 1000, 1.5e-2)
       for s in (None, 3) for lt in (True, False)},
    "embedding16": (dict(key=13, hidden=64, num_hidden=3, skip_layer=1, embedding_dim=16),
                    9, 700, 2e-2),
    "mixed-widths": (dict(key=11, hidden=[64, 32, 48, 64], num_hidden=4, skip_layer=2), 6,
                     700, 1.5e-2),
}


@pytest.mark.parametrize("case", CASES)
def test_nif_apply_t_f32_matches_pallas(case):
    kw, seed, p, budget = CASES[case]
    jp = _synthetic(**kw)
    model = nif.params_from_jax(jp)
    assert model.dtype == torch.float32
    u, v = _uv(seed, p)
    ref = np.asarray(nif_apply_pallas(jp, jnp.asarray(u), jnp.asarray(v), block_size=256,
                                      interpret=True))
    before = nif_ops.nif_apply_t.launches
    got = nif_ops.nif_apply_t(model, torch.from_numpy(u), torch.from_numpy(v))
    assert nif_ops.nif_apply_t.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (3, p)
    assert _rel(got.t().numpy(), ref).max() < budget


@pytest.mark.parametrize("case", CASES)
def test_env_shade_f32_matches_reference(case):
    """The plain f32 env shade against the reference's composition of the
    same function (equirect (u, v), nif_apply, bgr flip, escape weights)
    at the f32 budgets.  Not against nif_env_shade_pallas: its encode's
    double-angle recurrence alone puts it 2.7e-2 off that composition at
    the 12th octave of these escapes (skip None, no log decode), past
    its own f32 budget, while the port's direct angles stay within 2e-3."""
    kw, seed, p, budget = CASES[case]
    jp = _synthetic(**kw)
    rng = np.random.default_rng(seed + 100)
    d = rng.normal(size=(3, p)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    escaped = rng.uniform(size=p) < 0.8
    d[:, ~escaped] = 0.0
    w = rng.uniform(0.0, 2.0, (3, p)).astype(np.float32)
    w[:, ~escaped] = 0.0
    u, v = jequirect_uv(JVec3(*(jnp.asarray(x) for x in d)), jnp.float32(0.7))
    u = jnp.where(jnp.asarray(escaped), u, 0.0)
    v = jnp.where(jnp.asarray(escaped), v, 0.0)
    out = np.asarray(jnif.nif_apply(jp, u, v))  # (P, 3) network (bgr) order
    ref = w * out[:, ::-1].T
    before = nif_ops.nif_env_shade.launches
    got = nif_ops.nif_env_shade(nif.params_from_jax(jp), Vec3(*(torch.from_numpy(x) for x in d)),
                                Vec3(*(torch.from_numpy(x) for x in w)), 0.7)
    assert nif_ops.nif_env_shade.launches == before  # CPU tensors: the plain version
    assert _rel(got.stack().numpy(), ref).max() < budget


@pytest.mark.parametrize("hidden", [64, [64, 32, 48]])
def test_plain_megastep_f32_matches_reference_composition(hidden):
    """K3's plain version with f32 weights against the JAX package's
    composition on the same host noise (tests/test_megastep.py::_setup's
    shapes and noise, f32 params): fewer than 0.5% of lanes with a
    flipped path length, the f32 budget on the rest."""
    from test_megastep import H, W, _setup

    scene, cfg, settings, _, cols, rows, noise = _setup(hidden=hidden)
    jp = _synthetic(key=5, hidden=hidden, num_hidden=3, skip_layer=1)
    ref_rad, ref_plen = _xla_twin(scene, cfg, settings, jp, cols, rows, noise)
    model = nif.params_from_jax(jp)
    out = megastep.render_megastep(default_scene(), RenderSettings.make(samples_per_step=4),
                                   model, torch.from_numpy(np.array(cols)),
                                   torch.from_numpy(np.array(rows)),
                                   noise=torch.from_numpy(noise), width=W, height=H,
                                   max_path_length=MAXLEN)
    flipped = out.path_len.numpy() != ref_plen
    assert flipped.mean() < 5e-3
    rel = _rel(out.radiance.stack().numpy(), ref_rad)[:, ~flipped]
    assert rel.max() < 1.5e-2


def test_canonical_f32_plan_bytes():
    """The canonical 6x320 net's f32 plan (csrc/nif_wgmma.cuh's comment):
    the 64-ray tile, 10 activation atoms of 32 K values (81,920 B), 2
    feature atoms (16,384 B), 3 stages of 40,960 B, 223,296 B in all; each
    layer twice bf16's slices, 2,222,080 B per 64-ray tile; K3's plan
    227,712 B.  No layer has a lo part (the asset's weights are f16
    values, so tf32 values)."""
    model = nif.load_nif_assets(CANONICAL, torch.float32)[0]
    plan = nif_ops.wgmma_plan(model)
    assert nif_ops.tile_rays(plan["elem"]) == 64 and plan["elem"] == 4
    assert (plan["act_atoms"], plan["feat_atoms"], plan["stages"], plan["stage_bytes"],
            plan["smem_feat"], plan["smem_ring"], plan["smem_bytes"]) == (
        10, 2, 3, 40_960, 81_920, 98_304, 223_296)
    assert [(lay["chunks"], lay["in_atoms"], lay["f_atoms"]) for lay in plan["layers"]] == [
        (5, 0, 2), (5, 10, 0), (5, 10, 0), (5, 10, 2), (5, 10, 0), (5, 10, 0), (0, 10, 0)]
    assert sum((lay["in_atoms"] + lay["f_atoms"]) * lay["slice_bytes"]
               for lay in plan["layers"]) == 2_222_080
    assert megastep.megastep_wg_plan(model, default_scene())["smem_bytes"] == 227_712
    assert megastep.env_skip_tile(model) == 64
    assert nif_ops.wgmma_lo_slices(model) == [None] * 7
    net = nif_ops.wg_struct(model)
    assert (net.tf32, net.int8) == (1, 0) and not any(net.w_lo[:7])


def _f32_model(widths, embed=12, head=3, skip=None, seed=0):
    rng = np.random.default_rng(seed)
    dims, cur = [], 4 * embed
    for i, w in enumerate(widths + [head]):
        dims.append((cur + 4 * embed if i == skip else cur, w))
        cur = w
    kernels = [torch.from_numpy((rng.normal(size=d) / np.sqrt(d[0])).astype(np.float32))
               for d in dims]
    biases = [torch.from_numpy(rng.normal(size=d[1]).astype(np.float32) * 0.1) for d in dims]
    return nif.NifModel(kernels, biases, 1.0, [0.0, 0.0, 0.0], False)


@pytest.mark.parametrize("widths, embed, head, match", [
    ([448], 12, 3, "hidden widths up to 384"),
    ([320], 12, 16, "head takes at most 8"),
    ([64] * 16, 12, 3, "at most 16"),
    ([320, 320], 128, 3, "shared memory"),
])
def test_f32_unsupported_shapes_raise(widths, embed, head, match):
    """Shapes the tf32 chain cannot take raise with the limit named (the
    kernel's plan, with no fallback); 4E = 512 f32 features need 131,072 B
    beside 81,920 B of activations, too much for two ring stages."""
    model = _f32_model(widths, embed, head)
    with pytest.raises(ValueError, match=match):
        nif_ops.wgmma_plan(model)
    with pytest.raises(ValueError, match=match):
        nif_ops.wg_struct(model)


def _unswizzle32(image: np.ndarray) -> np.ndarray:
    """(atoms, rows, 32) f32 swizzle image -> (rows, 32 * atoms): element e
    of 16-byte chunk c of row r (4 f32 values) was stored at chunk
    c ^ (r % 8)."""
    atoms, rows, _ = image.shape
    r = np.arange(rows)[:, None]
    idx = np.arange(8)[None, :] ^ (r % 8)
    chunks = image.reshape(atoms, rows, 8, 4)[:, r, idx, :]
    return chunks.transpose(1, 0, 2, 3).reshape(rows, atoms * 32)


def _tf32(x: np.ndarray) -> np.ndarray:
    """Round to nearest tf32, ties away from zero, in NumPy (an independent
    formula: the magnitude rounded on a 2^-10 grid of its binade)."""
    m, e = np.frexp(np.abs(x).astype(np.float64))  # x = m 2^e, m in [0.5, 1)
    return (np.sign(x) * np.floor(m * 2048.0 + 0.5) / 2048.0 * 2.0 ** e).astype(np.float32)


def test_tf32_split_matches_numpy():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -12)]  # ties away from zero
    hi, lo = nif_ops.tf32_split(torch.from_numpy(x))
    np.testing.assert_array_equal(hi.numpy(), _tf32(x))
    np.testing.assert_array_equal(lo.numpy(), _tf32(x - _tf32(x)))
    assert (hi.numpy().view(np.uint32) & 0x1FFF == 0).all()


def test_f32_slices_carry_the_weights():
    """Each layer's hi slices un-swizzle to tf32(W) and its lo slices to
    tf32(W - tf32(W)) (random f32 weights have a lo part), every pad zero;
    hi + lo is W to within 2^-22 relative."""
    model = _f32_model([64, 96, 64], skip=2, seed=3)
    plan = nif_ops.wgmma_plan(model)
    los = nif_ops.wgmma_lo_slices(model)
    for lay, w, (hi_s, bias), lo_s in zip(plan["layers"], model.kernels,
                                          nif_ops.wgmma_operands(model), los):
        assert hi_s.dtype == torch.float32 and lo_s is not None
        trunk = lay["in_atoms"] * 32
        wt = w.t().numpy()
        for image, want in ((hi_s, _tf32(wt)), (lo_s, _tf32(wt - _tf32(wt)))):
            flat = _unswizzle32(image.numpy())
            assert flat.shape == (lay["rows"], 32 * (lay["in_atoms"] + lay["f_atoms"]))
            got = np.zeros_like(flat)
            t = lay["trunk"]
            got[:lay["fan_out"], :t] = want[:, :t]
            got[:lay["fan_out"], trunk:trunk + lay["fan_in"] - t] = want[:, t:]
            np.testing.assert_array_equal(flat, got)
        rec = (_tf32(wt) + _tf32(wt - _tf32(wt))).astype(np.float64)
        assert np.abs(rec - wt).max() <= 2.0 ** -22 * np.abs(wt).max()


def _chain_3xtf32(model, u, v):
    """The tf32 kernel's arithmetic from its operands: f32 features and
    activations split into tf32 hi and lo, each layer's products over its
    trunk slices then its feature slices as hi.hi + lo.hi + hi.lo, f32
    bias and ReLU with no rounding between layers; the f32 decode."""
    plan = nif_ops.wgmma_plan(model)
    feats = nif.fourier_features(torch.from_numpy(u), torch.from_numpy(v),
                                 model.embedding_dim).numpy()
    fpad = np.zeros((u.shape[0], 32 * plan["feat_atoms"]), np.float32)
    fpad[:, :feats.shape[1]] = feats
    los = nif_ops.wgmma_lo_slices(model)
    x = None
    for lay, (slices, bias), lo_s in zip(plan["layers"], nif_ops.wgmma_operands(model), los):
        w_hi = _unswizzle32(slices.numpy()).astype(np.float64)
        w_lo = np.zeros_like(w_hi) if lo_s is None else _unswizzle32(lo_s.numpy()).astype(
            np.float64)
        a = np.concatenate(([x[:, :32 * lay["in_atoms"]]] if lay["in_atoms"] else [])
                           + ([fpad] if lay["f_atoms"] else []), axis=1)
        a_hi = _tf32(a)
        a_lo = _tf32(a - a_hi)
        y = (a_hi @ w_hi.T + a_lo @ w_hi.T + a_hi @ w_lo.T + bias.numpy()).astype(np.float32)
        x = np.maximum(y, 0.0)
    z = y[:, :3] * model.max + np.asarray(model.mean, np.float32)
    return np.exp(z) if model.log_tone_map else z


@pytest.mark.parametrize("which", ["canonical", "synthetic-skip3", "random-f32"])
def test_chain_from_f32_slices_matches_jax(which):
    """The packed hi/lo slices, read in the kernel's order with its 3xTF32
    split, compute the reference's f32 NIF within its f32 budget."""
    if which == "canonical":
        jp = jnif.load_nif_assets(CANONICAL, jnp.float32)[0]
    elif which == "synthetic-skip3":
        jp = _synthetic(key=7, hidden=64, num_hidden=3, skip_layer=3)
    else:
        model = _f32_model([96, 64, 80], skip=2, seed=5)
        jp = jnif.NifParams(kernels=tuple(jnp.asarray(k.numpy()) for k in model.kernels),
                            biases=tuple(jnp.asarray(b.numpy()) for b in model.biases),
                            max=jnp.float32(model.max), mean=jnp.asarray(model.mean, jnp.float32),
                            log_tone_map=jnp.bool_(model.log_tone_map))
    model = nif.params_from_jax(jp)
    u, v = _uv(12, 3000)
    ref = np.asarray(jnif.nif_apply(jp, jnp.asarray(u), jnp.asarray(v)))
    got = _chain_3xtf32(model, u, v)
    assert _rel(got, ref).max() < 1.5e-2


def test_cli_partials_float_matches_reference_composition(tmp_path, monkeypatch):
    """``--partials-type float --device cpu`` through the port's CLI, its
    one step on numpy host noise, against the JAX package's f32
    composition on the same noise (the reference's f32 weights of the
    canonical asset, tests/test_megastep.py::_xla_twin): each pixel's mean
    within the f32 budget, flipped lanes excluded (< 0.5%)."""
    w, h, spp, maxlen = 12, 10, 2, MAXLEN
    seen = {}
    render_step = app_mod.render_step

    def host_noise_step(scene, settings, static, work, seed, env, **kw):
        rng = np.random.default_rng(31)
        n = work.u.shape[0]
        noise = rng.uniform(0.0, 1.0, (spp, 4 + 4 * maxlen, n)).astype(np.float32)
        noise[:, 0:2] = rng.normal(size=(spp, 2, n))
        seen.update(noise=noise, u=work.u.numpy().copy(), v=work.v.numpy().copy(),
                    dtype=env.model.dtype)
        return render_step(scene, settings, static, work, None, env,
                           noise=torch.from_numpy(noise), **kw)

    monkeypatch.setattr(app_mod, "render_step", host_noise_step)
    out = tmp_path / "f32.png"
    assert cli.main(["-w", str(w), "-H", str(h), "-s", str(spp), "--samples-per-step", str(spp),
                     "--max-path-length", str(maxlen), "--assets", CANONICAL,
                     "--partials-type", "float", "--layout", "raster", "-o", str(out),
                     "--device", "cpu"]) == 0
    assert seen["dtype"] == torch.float32
    img = read_exr(str(tmp_path / "f32.exr"))
    jp = jnif.load_nif_assets(CANONICAL, jnp.float32)[0]
    live = seen["u"] < w
    cols = jnp.asarray(seen["u"][live].astype(np.float32))
    rows = jnp.asarray(seen["v"][live].astype(np.float32))
    ref_rad, ref_plen = _xla_twin(jdefault_scene(), JStaticConfig(width=w, height=h,
                                                                  max_path_length=maxlen),
                                  JRenderSettings.make(samples_per_step=spp), jp, cols, rows,
                                  seen["noise"][:, :, live])
    ref = np.zeros((h, w, 3), np.float32)
    ref[seen["v"][live], seen["u"][live]] = (ref_rad / spp).T
    plain = megastep.render_megastep_plain(
        default_scene(), RenderSettings.make(samples_per_step=spp),
        nif.load_nif_assets(CANONICAL, torch.float32)[0],
        torch.from_numpy(np.array(cols)), torch.from_numpy(np.array(rows)),
        noise=torch.from_numpy(seen["noise"][:, :, live]), width=w, height=h,
        max_path_length=maxlen)
    flipped = plain.path_len.numpy() != ref_plen
    assert flipped.mean() < 5e-3
    keep = np.ones((h, w), bool)
    keep[seen["v"][live][flipped], seen["u"][live][flipped]] = False
    assert img.shape == (h, w, 3)
    assert _rel(img[keep], ref[keep]).max() < 1.5e-2
