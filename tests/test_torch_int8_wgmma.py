"""The host side of the int8 chain K5 on wgmma s8 (csrc/nif_wgmma.cuh
ChainInt8, in K2, K3 and K4) and of the precision probe K8's int8 variants
on the same tile (csrc/quant_probe.cu ChainK8).

The kernels need an H100 (chip_smoke.py holds them bit for bit against
their plain versions there and reads IGMMA, no IMMA or HMMA, in their
SASS).  What the CPU checks is what the kernels are given and the
arithmetic their tiles do:
  * the s8 slices (ops/nif.wgmma_operands), un-swizzled by an independent
    numpy formula of the 64-byte swizzle, recover every layer's int8
    (out, in) weights exactly with every pad zero, for the int8 asset (its
    QAT grids), the canonical PTQ, the mixed-width net and an E = 16 net;
  * the int8 plan fits a block for K2/K4 and for K3 with every scene, with
    the bytes and stages csrc/nif_wgmma.cuh and csrc/megastep.cuh state;
  * a torch model of the tile - the slices read in kernel order (trunk
    slices, then feature slices; the skip layer as its output passes with
    two accumulator sets), integer dots, the f32 epilogue in the kernel's
    order - equals the port's plain chain (models/quant.quant_mlp_t) bit
    for bit, and the JAX package's quant_mlp_t within
    tests/test_torch_quant.py's int8 budget (median 1e-3, max 8e-2: the
    reference encodes by the double-angle recurrence);
  * K8's int8 slices, read the same way with the script's epilogue, equal
    probes/quant.probe_plain bit for bit;
  * the launchers' argument is a NifWg for an int8 model, and any other
    struct is refused;
  * chip_smoke.py's torch._int_mm chain (the int8 rows' library yardstick)
    equals the plain chain bit for bit;
  * probes/chain_ablation.py refuses a source edit that no longer
    applies, and needs CUDA.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_envskip import ENCLOSED

from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu.models import quant as jquant
from ipu_path_trace_tpu_torch.core.scene import default_scene
from ipu_path_trace_tpu_torch.core.scenefile import load_scene, scene_from_dict
from ipu_path_trace_tpu_torch.models import nif, quant
from ipu_path_trace_tpu_torch.ops import _lib, megastep
from ipu_path_trace_tpu_torch.ops import nif as nif_ops
from ipu_path_trace_tpu_torch.probes import chain_ablation
from ipu_path_trace_tpu_torch.probes import quant as probe

ROOT = Path(__file__).resolve().parent.parent
ASSETS = ROOT / "assets"
INT8_ASSET = ASSETS / "urban_alley_synth_nif_int8"
SHAPES = ["int8-asset", "canonical-ptq", "mixed-ptq", "e16-ptq"]
SCENES = {"default": default_scene, "enclosed": lambda: scene_from_dict(ENCLOSED),
          **{p.stem: (lambda p=p: load_scene(str(p)))
             for p in sorted((ASSETS / "scenes").glob("*.json"))}}
LIMIT = 232_448  # shared memory a block may use (csrc/nif_wgmma.cuh kWgSmemLimit)


def _weights(shape):
    """(weights, meta, amax or None) of an int8 shape, in the JAX package's
    loader (both quantisers take them)."""
    name = {"int8-asset": INT8_ASSET, "canonical-ptq": ASSETS / "urban_alley_synth_nif",
            "mixed-ptq": ASSETS / "nif_m128-128-80-128-128-128",
            "e16-ptq": ASSETS / "nif_w192e16"}[shape]
    _, meta, weights = jnif.load_nif_assets(str(name), jnp.bfloat16)
    amax = None
    if shape == "int8-asset":
        amax = json.loads((INT8_ASSET / "quant_amax.json").read_text())["amax"]
    return weights, meta, amax


def _model(shape):
    weights, meta, amax = _weights(shape)
    return quant.quantize_nif(weights, meta, grid=(64, 128), amax=amax)


def _unswizzle8(image: np.ndarray) -> np.ndarray:
    """(atoms, rows, 64) int8 image of the 64-byte swizzle -> (rows, 64 *
    atoms): 16-byte chunk c of row r was stored at chunk c ^ ((r // 2) % 4)."""
    atoms, rows, _ = image.shape
    r = np.arange(rows)[:, None]
    idx = np.arange(4)[None, :] ^ ((r // 2) % 4)
    chunks = image.reshape(atoms, rows, 4, 16)[:, r, idx, :]
    return chunks.transpose(1, 0, 2, 3).reshape(rows, atoms * 64)


@pytest.mark.parametrize("shape", SHAPES)
def test_s8_slices_unswizzle_to_the_weights(shape):
    """Each layer's s8 slices recover its int8 (out, in) weights exactly -
    the trunk slices its trunk columns, the feature slices (layer 0 and the
    skip layer) the feature columns - with every pad zero; the bias and
    the multipliers are the layer's, padded with zeros to the rows."""
    model = _model(shape)
    plan = nif_ops.wgmma_plan(model)
    assert plan["elem"] == 1
    mults, mult_skip, inv_next = nif_ops.wgmma_scales(model)
    np.testing.assert_array_equal(np.float32(inv_next), model.inv_next.numpy())
    for lay, w, b, m, (slices, bias), mp in zip(plan["layers"], model.kernels, model.biases,
                                                model.mults, nif_ops.wgmma_operands(model),
                                                mults):
        n_slices = lay["in_atoms"] + lay["f_atoms"]
        assert slices.dtype == torch.int8 and slices.is_contiguous()
        assert slices.shape == (n_slices, lay["rows"], 64)
        assert slices.numel() == n_slices * lay["slice_bytes"] == n_slices * lay["rows"] * 64
        flat = _unswizzle8(slices.numpy())
        wt = w.t().numpy()
        fan_out, trunk, k_act = lay["fan_out"], lay["trunk"], 64 * lay["in_atoms"]
        feat = lay["fan_in"] - trunk
        np.testing.assert_array_equal(flat[:fan_out, :trunk], wt[:, :trunk])
        np.testing.assert_array_equal(flat[:fan_out, k_act:k_act + feat], wt[:, trunk:])
        pad = np.ones_like(flat, dtype=bool)
        pad[:fan_out, :trunk] = False
        pad[:fan_out, k_act:k_act + feat] = False
        assert not flat[pad].any()
        for full, padded in ((b, bias), (m, mp)):
            assert padded.dtype == torch.float32 and padded.shape == (lay["rows"],)
            assert torch.equal(padded[:fan_out], full) and not padded[fan_out:].any()
    assert torch.equal(mult_skip[:model.mult_skip.shape[0]], model.mult_skip)
    assert model.skip_layer < 0 or mult_skip.shape == (plan["layers"][model.skip_layer]["rows"],)


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_plan_fits_k2_k4(shape):
    """K2/K4's int8 plan: within the block's 227 KB, pieces in order on
    1024-byte boundaries, every slice in a ring stage, the skip layer (and
    only it) in passes of 128 outputs, whose rows of a slice start on
    512-byte (swizzle) boundaries, with the codes of all passes but the
    last staged."""
    model = _model(shape)
    plan = nif_ops.wgmma_plan(model)
    atom = nif_ops.WG_RAYS * 64
    assert plan["smem_bytes"] <= LIMIT and 2 <= plan["stages"] <= 4
    assert plan["smem_feat"] == plan["act_atoms"] * atom
    assert plan["smem_codes"] == plan["smem_feat"] + plan["feat_atoms"] * atom
    passes = max(lay["passes"] for lay in plan["layers"])
    assert plan["smem_ring"] - plan["smem_codes"] == 128 * 128 * (passes - 1)
    assert plan["smem_bar"] == plan["smem_ring"] + plan["stages"] * plan["stage_bytes"]
    for key in ("smem_feat", "smem_codes", "smem_ring", "smem_bar"):
        assert plan[key] % 1024 == 0, key
    for i, lay in enumerate(plan["layers"]):
        assert lay["slice_bytes"] == lay["rows"] * 64 <= plan["stage_bytes"]
        skip = i > 0 and lay["trunk"] != lay["fan_in"]
        assert lay["passes"] == (-(-lay["chunks"] // 2) if skip else 1)
        if skip:  # a pass's rows of a slice: 128 x 64 B, whole swizzle atoms
            assert 128 * (lay["passes"] - 1) < lay["rows"] <= 128 * lay["passes"]


def test_canonical_int8_plan_bytes():
    """The canonical int8 plan as csrc/nif_wgmma.cuh states it: 5
    activation atoms and 1 feature atom of 8,192 B, 32,768 B for the codes
    of the skip layer's first two passes (of three), 4 stages of 20,480 B,
    165,952 B for K2/K4 (174,880 B for K3 on the default scene), and
    555,520 B of slices per tile (half of bf16's 1,111,040)."""
    model = _model("int8-asset")
    plan = nif_ops.wgmma_plan(model)
    assert (plan["act_atoms"], plan["feat_atoms"], plan["stages"], plan["stage_bytes"],
            plan["smem_bytes"]) == (5, 1, 4, 20_480, 165_952)
    assert (plan["smem_codes"], plan["smem_ring"]) == (49_152, 81_920)
    assert [(lay["chunks"], lay["in_atoms"], lay["f_atoms"], lay["passes"])
            for lay in plan["layers"]] == [(5, 0, 1, 1), (5, 5, 0, 1), (5, 5, 0, 1),
                                           (5, 5, 1, 3), (5, 5, 0, 1), (5, 5, 0, 1),
                                           (0, 5, 0, 1)]
    assert sum((lay["in_atoms"] + lay["f_atoms"]) * lay["slice_bytes"]
               for lay in plan["layers"]) == 555_520
    k3 = megastep.megastep_wg_plan(model, default_scene())
    assert (k3["stages"], k3["smem_bytes"]) == (4, 174_880)


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("shape", SHAPES)
def test_int8_plan_fits_k3(shape, scene_name):
    """K3's int8 plan on every scene: the chain's plan with K3's tail and
    the scene's tables, within 227 KB, with 4 stages (the s8 slices are
    half the bf16 ones, so every shipped scene keeps the most)."""
    model, scene = _model(shape), SCENES[scene_name]()
    plan = megastep.megastep_wg_plan(model, scene)
    chain = nif_ops.wgmma_plan(model)
    for key in ("layers", "act_atoms", "feat_atoms", "stage_bytes", "smem_feat", "smem_ring"):
        assert plan[key] == chain[key], key
    assert plan["stages"] == 4 and plan["smem_bytes"] <= LIMIT
    assert plan["smem_tables"] == plan["smem_uv"] + megastep.MEGA_TAIL_BYTES
    net = megastep.kernel_net(model, scene)
    assert isinstance(net, _lib.NifWg) and net.int8 == 1 and net.smem_bytes == plan["smem_bytes"]


def _codes(y: torch.Tensor, inv: float) -> torch.Tensor:
    """K5's requant of a hidden layer (ChainInt8::code)."""
    return torch.clamp(torch.round(torch.relu(y) * inv) - 128.0, -128.0, 127.0)


def _tile_chain(plan, operands, scales, feats, dense, skip, code):
    """The 8-bit tile's arithmetic from its operands: per layer the s8
    slices un-swizzled and read in kernel order - activation slices, then
    feature slices - as exact integer dots; the skip layer in its passes of
    128 outputs, each with a trunk and a feature accumulator; the epilogue
    dense/skip, then code for hidden layers.  ``feats`` (B, 64 *
    feat_atoms) integer codes.  Returns the head's (B, rows) f32."""
    mults, mult_skip, inv_next = scales
    x = None
    for i, (lay, (slices, bias)) in enumerate(zip(plan["layers"], operands)):
        w = torch.from_numpy(_unswizzle8(slices.numpy())).to(torch.int64)
        k_act = 64 * lay["in_atoms"]
        rows = lay["rows"]
        trunk = x[:, :k_act] if k_act else None
        y = torch.empty((feats.shape[0], rows), dtype=torch.float32)
        if k_act and lay["f_atoms"]:  # the skip layer: two dots, pass by pass
            assert lay["passes"] == -(-rows // 128)
            for p in range(lay["passes"]):
                out = slice(128 * p, min(rows, 128 * (p + 1)))
                acc = trunk @ w[out, :k_act].t()
                accf = feats @ w[out, k_act:].t()
                y[:, out] = skip(acc, accf, mults[i][out], mult_skip[out], bias[out])
        else:
            a = trunk if k_act else feats
            y = dense(a @ w.t(), mults[i], bias)
        if lay["chunks"] == 0:
            return y
        x = code(y, inv_next[i]).to(torch.int64)


def _k5_dense(acc, m, b):
    y = acc.float() * m
    return y + b


def _k5_skip(acc, accf, m, mf, b):
    y = acc.float() * m
    y = y + accf.float() * mf
    return y + b


@pytest.mark.parametrize("shape", SHAPES)
def test_tile_matches_plain_and_jax(shape):
    """The int8 tile's arithmetic from the s8 slices equals the port's
    plain chain (quant_mlp_t, the head's (3, B) f32) bit for bit and its
    decode nif_apply_quant's, and the JAX package's quant_mlp_t within the
    int8 budget."""
    weights, meta, amax = _weights(shape)
    model = quant.quantize_nif(weights, meta, grid=(64, 128), amax=amax)
    rng = np.random.default_rng(17)
    u, v = rng.uniform(0.0, 1.0, (2, 600)).astype(np.float32)
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    plan = nif_ops.wgmma_plan(model)
    codes = quant.quantize_features(nif.fourier_features(ut, vt, model.embedding_dim))
    feats = torch.zeros((600, 64 * plan["feat_atoms"]), dtype=torch.int64)
    feats[:, :codes.shape[1]] = codes.to(torch.int64)
    head = _tile_chain(plan, nif_ops.wgmma_operands(model), nif_ops.wgmma_scales(model), feats,
                       _k5_dense, _k5_skip, _codes)[:, :3]
    want = quant.quant_mlp_t(model, ut, vt)
    assert torch.equal(head.t(), want)
    z = head * model.max + torch.tensor(model.mean)
    decoded = torch.exp(z) if model.log_tone_map else z
    assert torch.equal(decoded, quant.nif_apply_quant(model, ut, vt))
    if amax is None:  # the reference's lattice calibration, handed to both quantisers
        amax = jquant._f32_chain_activations(
            weights, jquant.calibration_features(meta.embedding_dimension, (64, 128)))
    ref_model = quant.quantize_nif(weights, meta, amax=amax)
    ref = np.asarray(jquant.quant_mlp_t(jquant.quantize_nif(weights, meta, amax=amax),
                                        jnp.asarray(u), jnp.asarray(v)))
    got = _tile_chain(plan, nif_ops.wgmma_operands(ref_model), nif_ops.wgmma_scales(ref_model),
                      feats, _k5_dense, _k5_skip, _codes)[:, :3].t().numpy()
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-2 * np.abs(ref).max())
    assert np.median(rel) < 1e-3 and rel.max() < 8e-2


@pytest.mark.parametrize("shape", SHAPES)
def test_int_mm_yardstick_equals_the_plain_chain(shape):
    """chip_smoke.py's torch._int_mm chain, the int8 rows' library yardstick,
    computes the same function as the port's plain chain: its head equals
    quant_mlp_t bit for bit (widths padded to 16, the requant in place)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    model = _model(shape)
    rng = np.random.default_rng(23)
    ut, vt = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 600)).astype(np.float32))
    codes = quant.quantize_features(nif.fourier_features(ut, vt, model.embedding_dim))
    head = smoke.int_mm_chain(model, codes)()
    assert head.shape == (600, 16) and not head[:, 3:].any()
    assert torch.equal(head[:, :3].t(), quant.quant_mlp_t(model, ut, vt))
    assert smoke.int_mm_chain(model, codes, epilogue=False)().shape == (600, 16)


@pytest.mark.parametrize("variant", ["int8_requant", "int8_perchan", "int8_raw"])
def test_k8_int8_tile_matches_probe_plain(variant):
    """K8's int8 slices, read as the tile reads them, with the script's
    epilogue (fma as XLA fuses it, the variant's next code), equal
    probes/quant.probe_plain bit for bit on all eight head rows."""
    feats, ws, bs, _, xmax = probe.calibration(probe.PAD, 512)
    ops = probe.build_operands(variant, ws, bs, feats, xmax)
    net = probe._kernel_net(ops)
    assert isinstance(net, _lib.NifWg) and net.int8 == 1
    plan = probe.probe_plan(ops)
    operands, scales = ops._net[1]
    code = {"int8_raw": lambda y, _: probe.to_int8(torch.relu(y))}.get(
        variant, lambda y, s: torch.clamp(torch.round(torch.relu(y) * s), -127.0, 127.0))
    head = _tile_chain(
        plan, operands, scales, ops.feats.t().to(torch.int64),
        lambda acc, m, b: probe._fma(acc.float(), m, b),
        lambda acc, accf, m, mf, b: probe._fma(acc.float(), m, accf.float() * mf) + b, code)
    assert torch.equal(head.t(), probe.probe_plain(ops))


def test_launchers_take_an_int8_nifwg_and_refuse_a_nifnet():
    """K2/K4 and K3 hand an int8 model a NifWg with its flag, passes,
    multipliers and quant steps; the launchers' argument (ops/nif.wg_arg)
    refuses any other struct and anything else."""
    model = _model("int8-asset")
    for wg in (nif_ops.wg_struct(model), megastep.kernel_net(model, default_scene())):
        assert nif_ops.wg_arg(wg)._obj is wg and wg.int8 == 1
        assert list(wg.passes[:7]) == [1, 1, 1, 3, 1, 1, 1]
        mults, mult_skip, _ = nif_ops.wgmma_scales(model)
        assert [wg.mult[i] for i in range(7)] == [m.data_ptr() for m in mults]
        assert wg.mult_skip == mult_skip.data_ptr()
        np.testing.assert_array_equal(np.float32(list(wg.inv_next[:7])), model.inv_next.numpy())
    with pytest.raises(ValueError, match="NifWg"):
        nif_ops.wg_arg(_lib.TraceParams())
    with pytest.raises(ValueError, match="NifWg"):
        nif_ops.wg_arg(None)


def test_chain_ablation_refuses_an_edit_that_no_longer_applies(tmp_path, monkeypatch):
    """The probe builds each ablation from an edited copy of csrc/: an edit
    whose text is found is applied, and one whose text is gone (the chain
    changed since) raises before anything is built or timed."""
    csrc = tmp_path / "ipu_path_trace_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cuh").write_text("int a = 1;\n")
    monkeypatch.setattr(chain_ablation, "ROOT", tmp_path)
    out = chain_ablation.build_variant("edit", [("k.cuh", "a = 1", "a = 2")])
    assert (out / "k.cuh").read_text() == "int a = 2;\n"
    with pytest.raises(RuntimeError, match="no longer applies"):
        chain_ablation.build_variant("stale", [("k.cuh", "b = 1", "b = 2")])


def test_chain_ablation_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the check is for hosts without one")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        chain_ablation.main()
