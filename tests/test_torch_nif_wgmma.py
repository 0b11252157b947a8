"""The host side of K2/K4's bf16 wgmma chain (csrc/nif_wgmma.cuh).

The kernel itself needs an H100 (chip_smoke.py holds it against its
plain version there); what the CPU can check is what the kernel is
given: the swizzled weight slices, un-swizzled here by an independent
numpy formula, recover each layer's bf16 (out, in) matrix exactly with
every pad zero; the shared-memory plan fits a block on every NIF asset
and synthetic shape; the shapes the chain cannot take raise; and a chain
run from the packed slices in the kernel's K order (trunk slices, then
the feature slices, every layer's K padded to 64) matches the JAX
package's nif_apply within the reference's bf16 budget (median 5e-3,
max 8e-2 relative, floored at 1% of the peak: tests/test_nif_pallas.py).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_path_trace_tpu.models import nif as jnif
from ipu_path_trace_tpu_torch.models import nif
from ipu_path_trace_tpu_torch.models.quant import quantize_nif
from ipu_path_trace_tpu_torch.ops import _lib
from ipu_path_trace_tpu_torch.ops import nif as nif_ops

ASSETS = ["assets/urban_alley_synth_nif", "assets/procedural_sky_nif", "assets/nif_w128",
          "assets/nif_w192", "assets/nif_w192e16", "assets/nif_w256e16",
          "assets/nif_m128-128-80-128-128-128"]
SYNTHETIC = ["synthetic-64", "synthetic-64-32-48", "synthetic-384"]
SHAPES = ASSETS + SYNTHETIC


def _jax_params(shape):
    """The reference's bf16 NifParams of an asset or a synthetic shape."""
    if shape.startswith("synthetic"):
        widths = [int(x) for x in shape.split("-")[1:]]
        weights, meta = jnif.make_synthetic_nif(key=7, hidden=widths if len(widths) > 1
                                                else widths[0], num_hidden=3, skip_layer=1)
        return jnif.make_params(weights, meta, jnp.bfloat16)
    return jnif.load_nif_assets(shape, jnp.bfloat16)[0]


def _unswizzle(image: np.ndarray) -> np.ndarray:
    """(atoms, rows, 64) swizzle image -> (rows, 64 * atoms): element e of
    16-byte chunk c of row r was stored at chunk c ^ (r % 8)."""
    atoms, rows, _ = image.shape
    r = np.arange(rows)[:, None]
    idx = np.arange(8)[None, :] ^ (r % 8)
    chunks = image.reshape(atoms, rows, 8, 8)[:, r, idx, :]
    return chunks.transpose(1, 0, 2, 3).reshape(rows, atoms * 64)


@pytest.mark.parametrize("shape", SHAPES)
def test_slices_unswizzle_to_the_weights(shape):
    """Each layer's slices recover its bf16 (out, in) matrix exactly - the
    trunk slices its trunk columns, the feature slices (layer 0 and the skip
    layer) the feature columns - and every pad entry is zero; the bias is
    the layer's, in f32, padded with zeros."""
    model = nif.params_from_jax(_jax_params(shape))
    plan = nif_ops.wgmma_plan(model)
    for lay, w, b, (slices, bias) in zip(plan["layers"], model.kernels, model.biases,
                                         nif_ops.wgmma_operands(model)):
        n_slices = lay["in_atoms"] + lay["f_atoms"]
        assert slices.dtype == torch.bfloat16 and slices.is_contiguous()
        assert slices.shape == (n_slices, lay["rows"], 64)
        assert slices.numel() * 2 == n_slices * lay["slice_bytes"]
        flat = _unswizzle(slices.float().numpy())
        wt = w.t().float().numpy()
        fan_out, trunk, k_act = lay["fan_out"], lay["trunk"], 64 * lay["in_atoms"]
        feat = lay["fan_in"] - trunk
        np.testing.assert_array_equal(flat[:fan_out, :trunk], wt[:, :trunk])
        np.testing.assert_array_equal(flat[:fan_out, k_act:k_act + feat], wt[:, trunk:])
        pad = np.ones_like(flat, dtype=bool)
        pad[:fan_out, :trunk] = False
        pad[:fan_out, k_act:k_act + feat] = False
        assert not flat[pad].any()
        assert bias.dtype == torch.float32 and bias.shape == (lay["rows"],)
        assert torch.equal(bias[:fan_out], b.float()) and not bias[fan_out:].any()


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_a_block(shape):
    """The shared-memory plan the launcher uses stays within 227 KB, its
    pieces lie in order without overlap, the swizzled ones on 1024-byte
    boundaries, and every fill of the ring (a slice, or a pass's rows of
    one for a layer in passes) fits a stage."""
    model = nif.params_from_jax(_jax_params(shape))
    plan = nif_ops.wgmma_plan(model)
    assert plan["smem_bytes"] <= 232_448
    assert 2 <= plan["stages"] <= 4
    atom = nif_ops.WG_ATOM_BYTES
    assert plan["smem_feat"] == plan["act_atoms"] * atom
    assert plan["smem_ring"] == plan["smem_feat"] + plan["feat_atoms"] * atom
    assert plan["smem_bar"] == plan["smem_ring"] + plan["stages"] * plan["stage_bytes"]
    assert plan["smem_uv"] == plan["smem_bar"] + 64
    assert plan["smem_bytes"] == plan["smem_uv"] + 1024 + 1024
    for key in ("smem_feat", "smem_ring", "smem_bar", "stage_bytes"):
        assert plan[key] % 1024 == 0, key
    assert plan["feat_atoms"] * 64 >= 4 * model.embedding_dim
    layers = plan["layers"]
    assert [lay["chunks"] for lay in layers[-1:]] == [0] and layers[-1]["rows"] == 8
    for i, lay in enumerate(layers):
        assert lay["slice_bytes"] == lay["rows"] * 128
        assert lay["fill_bytes"] <= plan["stage_bytes"]
        assert lay["fill_bytes"] * lay["passes"] >= lay["slice_bytes"]
        assert lay["in_atoms"] <= plan["act_atoms"]
        assert (lay["f_atoms"] > 0) == (i == 0 or lay["trunk"] != lay["fan_in"])
        if i:  # the trunk is the previous layer's output
            assert lay["trunk"] == layers[i - 1]["fan_out"]


def test_canonical_plan_bytes():
    """The canonical 6x320 net's plan, as csrc/nif_wgmma.cuh's comment
    states it: 5 activation atoms, 1 feature atom, 3 stages of 40,960 B,
    223,296 B in all, 1,111,040 B of slices per tile."""
    model, _, _ = nif.load_nif_assets("assets/urban_alley_synth_nif")
    plan = nif_ops.wgmma_plan(model)
    assert (plan["act_atoms"], plan["feat_atoms"], plan["stages"], plan["stage_bytes"],
            plan["smem_bytes"]) == (5, 1, 3, 40_960, 223_296)
    assert [(lay["chunks"], lay["in_atoms"], lay["f_atoms"]) for lay in plan["layers"]] == [
        (5, 0, 1), (5, 5, 0), (5, 5, 0), (5, 5, 1), (5, 5, 0), (5, 5, 0), (0, 5, 0)]
    per_tile = sum((lay["in_atoms"] + lay["f_atoms"]) * lay["slice_bytes"]
                   for lay in plan["layers"])
    assert per_tile == 1_111_040


def _model(widths, embed=12, head=3, skip=None):
    """A random bf16 NifModel with the given hidden widths."""
    rng = np.random.default_rng(0)
    feat = 4 * embed
    dims, cur = [], feat
    for i, w in enumerate(widths + [head]):
        fan_in = cur + feat if i == skip else cur
        dims.append((fan_in, w))
        cur = w
    kernels = [torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(torch.bfloat16)
               for d in dims]
    biases = [torch.zeros(d[1], dtype=torch.bfloat16) for d in dims]
    return nif.NifModel(kernels, biases, 1.0, [0.0, 0.0, 0.0], False)


@pytest.mark.parametrize("widths, embed, head, match", [
    ([448, 448], 12, 3, "hidden widths up to 384"),
    ([320, 320], 12, 16, "head takes at most 8"),
    ([64] * 16, 12, 3, "at most 16"),
    ([320, 320], 128, 3, "shared memory"),
])
def test_unsupported_shapes_raise(widths, embed, head, match):
    model = _model(widths, embed, head)
    with pytest.raises(ValueError, match=match):
        nif_ops.wgmma_plan(model)
    with pytest.raises(ValueError, match=match):  # the launch path raises, with no fallback
        nif_ops.wg_struct(model)


@pytest.mark.parametrize("chain, plan_k2, plan_k3", [
    ("bf16", (4, 24_576, 215_104), 224_032),
    ("int8", (4, 12_288, 157_760), 166_688),
    ("f32", (2, 49_152, 215_104), 224_032),
])
def test_wide_plan_384(chain, plan_k2, plan_k3):
    """A 6x384 net (six 64-wide chunks a hidden layer) fits every chain's
    block beside K3's tail: bf16 and int8 run each hidden layer in two
    passes of three chunks (the int8 skip layer its three passes of 128
    outputs), so a ring stage holds a pass's rows and four stages fit; the
    tf32 chain's groups take three chunks each, in one pass, two stages of
    whole slices.  (stages, stage bytes, K2/K4 plan bytes), K3's plan bytes."""
    from ipu_path_trace_tpu_torch.core.scene import default_scene
    from ipu_path_trace_tpu_torch.ops import megastep

    weights, meta = nif.make_synthetic_nif(0, hidden=384)
    model = (quantize_nif(weights, meta, grid=(16, 32)) if chain == "int8" else
             nif.make_params(weights, meta, torch.bfloat16 if chain == "bf16" else torch.float32))
    plan = nif_ops.wgmma_plan(model)
    assert (plan["stages"], plan["stage_bytes"], plan["smem_bytes"]) == plan_k2
    assert megastep.megastep_wg_plan(model, default_scene())["smem_bytes"] == plan_k3 <= 232_448
    skip = {"bf16": 2, "int8": 3, "f32": 1}[chain]
    passes = {"bf16": 2, "int8": 2, "f32": 1}[chain]
    assert [(lay["chunks"], lay["passes"]) for lay in plan["layers"]] == [
        (6, skip if i == 3 else passes) if i < 6 else (0, 1) for i in range(7)]
    assert [lay["passes"] for lay in plan["layers"]] == list(nif_ops.wg_struct(model).passes[:7])


def test_plain_nif_384_matches_jax():
    """The port's plain NIF on a 6x384 bf16 net (the JAX package's
    make_synthetic_nif weights) against the JAX package's nif_apply, within
    the reference's bf16 budget."""
    weights, meta = jnif.make_synthetic_nif(key=3, hidden=384)
    jp = jnif.make_params(weights, meta, jnp.bfloat16)
    model = nif.params_from_jax(jp)
    rng = np.random.default_rng(12)
    u, v = rng.uniform(0.0, 1.0, (2, 1000)).astype(np.float32)
    ref = np.asarray(jnif.nif_apply(jp, jnp.asarray(u), jnp.asarray(v)))
    got = nif.nif_apply(model, torch.from_numpy(u), torch.from_numpy(v)).numpy()
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-2 * np.abs(ref).max())
    assert np.median(rel) < 5e-3
    assert rel.max() < 8e-2


def test_kernel_nets_pick_the_chain():
    """K2/K4 get a NifWg for a bf16 model, for an int8 one (its int8 flag
    set) and for an f32 one (its tf32 flag set); the launchers' argument
    refuses any other struct; a model of another weight type raises."""
    model, meta, weights = nif.load_nif_assets("assets/urban_alley_synth_nif")
    f32 = nif.load_nif_assets("assets/urban_alley_synth_nif", torch.float32)[0]
    for m, int8, tf32 in ((model, 0, 0), (quantize_nif(weights, meta), 1, 0), (f32, 0, 1)):
        wg = nif_ops.wg_arg(nif_ops.wg_struct(m))
        assert isinstance(wg._obj, _lib.NifWg)
        assert (wg._obj.int8, wg._obj.tf32) == (int8, tf32)
    with pytest.raises(ValueError, match="NifWg"):
        nif_ops.wg_arg(_lib.TraceParams())
    with pytest.raises(ValueError, match="bf16, f32 or int8"):
        nif_ops.wg_struct(nif.load_nif_assets("assets/urban_alley_synth_nif",
                                              torch.float16)[0])


def test_wg_struct_layout():
    """The ctypes mirror keeps csrc/nif_wgmma.cuh::NifWg's field order and
    C layout, and carries the plan and the cached operands' pointers."""
    names = [f for f, _ in _lib.NifWg._fields_]
    assert names == ["num_layers", "embed_dim", "log_flag", "stages", "stage_bytes",
                     "feat_atoms", "smem_feat", "smem_ring", "smem_bar", "smem_uv",
                     "smem_bytes", "chunks", "in_atoms", "f_atoms", "slice_bytes", "w", "b",
                     "max_v", "mean", "int8", "smem_codes", "passes", "inv_next", "mult",
                     "mult_skip", "tf32", "w_lo"]
    # 11 + 4 x 16 ints (300 B), then the pointers at their 8-byte alignment;
    # the 8-bit chains' fields follow (2 + 16 ints, 16 floats, then pointers),
    # then the tf32 chain's flag and its lo slices' pointers.
    assert (_lib.NifWg.w.offset, _lib.NifWg.b.offset, _lib.NifWg.max_v.offset) == (304, 432, 560)
    assert (_lib.NifWg.int8.offset, _lib.NifWg.mult.offset, _lib.NifWg.mult_skip.offset) == (
        576, 712, 840)
    assert (_lib.NifWg.tf32.offset, _lib.NifWg.w_lo.offset) == (848, 856)
    assert ctypes.sizeof(_lib.NifWg) == 984
    model, _, _ = nif.load_nif_assets("assets/urban_alley_synth_nif")
    net = nif_ops.wg_struct(model)
    plan = nif_ops.wgmma_plan(model)
    assert (net.num_layers, net.embed_dim, net.log_flag, net.stages, net.smem_bytes) == (
        7, 12, 1, 3, plan["smem_bytes"])
    assert list(net.chunks[:7]) == [5, 5, 5, 5, 5, 5, 0]
    assert list(net.f_atoms[:7]) == [1, 0, 0, 1, 0, 0, 0]
    ops = nif_ops.wgmma_operands(model)
    assert nif_ops.wgmma_operands(model)[3][0] is ops[3][0]  # cached per model
    assert [net.w[i] for i in range(7)] == [w.data_ptr() for w, _ in ops]
    assert [net.b[i] for i in range(7)] == [b.data_ptr() for _, b in ops]
    assert (net.max_v, *net.mean) == (model.max, *model.mean)  # f32 values, stored exactly
    assert net.int8 == 0 and list(net.passes[:7]) == [1] * 7 and not any(net.mult[:7])
    assert net.tf32 == 0 and not any(net.w_lo[:7])


def _chain_from_slices(model, u, v):
    """The wgmma kernel's arithmetic from its operands: bf16 features and
    activations in 64-wide K atoms, each layer's products over its trunk
    slices then its feature slices with f32 sums, f32 bias, ReLU, bf16;
    the head's f32 decode.  (P, 3) network order."""
    plan = nif_ops.wgmma_plan(model)
    feats = nif.fourier_features(u, v, model.embedding_dim).to(torch.bfloat16).float()
    fpad = torch.zeros((u.shape[0], 64 * plan["feat_atoms"]))
    fpad[:, :feats.shape[1]] = feats
    x = None
    for lay, (slices, bias) in zip(plan["layers"], nif_ops.wgmma_operands(model)):
        w = torch.from_numpy(_unswizzle(slices.float().numpy()))
        inputs = ([x[:, :64 * lay["in_atoms"]]] if lay["in_atoms"] else []) + (
            [fpad] if lay["f_atoms"] else [])
        y = torch.cat(inputs, dim=1) @ w.t() + bias
        x = torch.relu(y).to(torch.bfloat16).float()
    z = y[:, :3] * model.max + torch.tensor(model.mean)
    return torch.exp(z) if model.log_tone_map else z


@pytest.mark.parametrize("shape", SHAPES)
def test_chain_from_slices_matches_jax(shape):
    """The packed slices, read in the kernel's order, compute the
    reference's NIF within its bf16 budget."""
    jp = _jax_params(shape)
    model = nif.params_from_jax(jp)
    rng = np.random.default_rng(11)
    u, v = rng.uniform(0.0, 1.0, (2, 700)).astype(np.float32)
    ref = np.asarray(jnif.nif_apply(jp, jnp.asarray(u), jnp.asarray(v)))
    got = _chain_from_slices(model, torch.from_numpy(u), torch.from_numpy(v)).numpy()
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-2 * np.abs(ref).max())
    assert np.median(rel) < 5e-3
    assert rel.max() < 8e-2


def test_launcher_signatures_match_the_sources():
    """Every launcher's ctypes argtypes (ops/_lib.py::library) has as many
    entries as its extern "C" signature in csrc/ has parameters: ctypes
    passes extra arguments as C ints, which cuts a pointer.  Where a
    launcher takes a NifWg (K2, K3, K4, K6, K7 - pt_probe_loop - and K8),
    its argtypes declare the NifWg pointer, and nowhere else."""
    import ast
    import re
    from pathlib import Path

    csrc = Path(_lib.__file__).resolve().parent.parent / "csrc"
    params, takes_wg = {}, set()
    for src in _lib.SOURCES:
        text = (csrc / src).read_text()
        for name, args in re.findall(r'extern "C" [\w\s*]+?\b(pt_\w+)\(([^)]*)\)', text):
            params[name] = len([a for a in args.split(",") if a.strip()])
            takes_wg |= {(name, i) for i, a in enumerate(args.split(",")) if "NifWg" in a}
    declared, declared_wg = {}, set()
    for node in ast.walk(ast.parse(Path(_lib.__file__).read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Attribute)
                and node.targets[0].attr == "argtypes"):
            name = node.targets[0].value.attr
            declared[name] = len(node.value.elts)
            declared_wg |= {(name, i) for i, e in enumerate(node.value.elts)
                            if ast.unparse(e) == "wg"}
    assert set(declared) <= set(params) and {"pt_quant_probe", "pt_probe_loop"} <= set(declared)
    assert {k: params[k] for k in declared} == declared
    assert ("pt_probe_loop", 0) in takes_wg and len(takes_wg) == 7
    assert declared_wg == takes_wg


def test_mega_args_match_the_header():
    """K3's launch arguments cross the ABI as one struct: ops/_lib.py's
    MegaArgs names csrc/megastep.cuh::MegaArgs's members in order, a
    pointer as a pointer and an int as an int, at the C layout (ten
    pointers, three ints padded to eight bytes, four pointers)."""
    import re
    from pathlib import Path

    text = (Path(_lib.__file__).resolve().parent.parent / "csrc" / "megastep.cuh").read_text()
    body = re.search(r"struct MegaArgs \{(.*?)\n\};", text, re.S)[1]
    body = re.sub(r"//[^\n]*", "", body)
    members = []  # (name, is a pointer); each declaration is all pointers or none
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        members += [(re.search(r"(\w+)$", d.strip())[1], "*" in decl) for d in decl.split(",")]
    fields = [(n, t is ctypes.c_void_p) for n, t in _lib.MegaArgs._fields_]
    assert fields == members and len(fields) == 17
    assert {t for _, t in _lib.MegaArgs._fields_} == {ctypes.c_void_p, ctypes.c_int}
    assert (_lib.MegaArgs.budget_block.offset, _lib.MegaArgs.rad.offset) == (80, 96)
    assert ctypes.sizeof(_lib.MegaArgs) == 128
