"""The overlap probes' plain versions (probes/overlap.py) against the
scripts they port (scripts/overlap_probe.py, scripts/overlap_probe2.py).

The scripts time the TPU as soon as they are imported, so only their
function definitions and size constants are executed here, pulled out
with ``ast``: ``_mxu_chain``, ``_vpu_work``, ``_vpu_round`` and
``_interleaved``, on 256 lanes through the real ``LAYERS``.  Tolerances:
the bf16 chain within the reference's budget (median relative error 5e-3,
max 8e-2, floored at 1% of the peak; tests/test_nif_pallas.py), the ALU
chain to rtol 1e-5 on all but 5e-3 of the lanes (a lane next to the
x > 1 select may take the other branch after a last-bit difference in
sin).

K6's and K7's kernels run the bf16 wgmma tile (csrc/probes.cu on
csrc/nif_wgmma.cuh) and need an H100; here the CPU checks what they are
given - the probe model's NifWg plan fits a block and its swizzled slices
recover the scripts' weights exactly - and a CPU model of the tile (bf16(u)
in every feature row, the slices read in kernel order with f32 sums, ReLU
and a round to bf16 between layers, row 0 of the head, plus the ALU rounds
for 'both') against the plain versions and the scripts' chains within the
bf16 budget; the same tile iterated as K7's loop (one pass of the chain
per iteration, the carries updated in the kernel's order) for its four
variants; and that every chain probe's launch path takes the NifWg alone.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nif_wgmma import _unswizzle

from ipu_path_trace_tpu_torch.ops import _lib
from ipu_path_trace_tpu_torch.ops import nif as nif_ops
from ipu_path_trace_tpu_torch.ops.trace import philox4x32_10
from ipu_path_trace_tpu_torch.probes import overlap

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
N = 256
CONSTANTS = {"B", "GRID", "LAYERS", "VPU_ROUNDS", "LOOP"}


def _script(name: str) -> dict:
    """The script's size constants and helper functions, run with jnp."""
    tree = ast.parse((SCRIPTS / name).read_text())
    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef) and node.name.startswith("_"))
            or (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id in CONSTANTS for t in node.targets))]
    ns = {"jnp": jnp, "np": np}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(SCRIPTS / name), "exec"), ns)
    return ns


P1, P2 = _script("overlap_probe.py"), _script("overlap_probe2.py")


def _weights():
    return [jnp.asarray(np.random.default_rng(i).normal(size=(o, i_)).astype(np.float16) * 0.05,
                        jnp.bfloat16) for i, (o, i_) in enumerate(P1["LAYERS"])]


def _lanes(seed=7):
    return np.random.default_rng(seed).uniform(0.0, 1.0, N).astype(np.float32)


def _feats(v):
    return jnp.broadcast_to(jnp.asarray(v).astype(jnp.bfloat16), (48, N))


def _assert_chain_close(got, ref):
    ref = np.asarray(ref, np.float32)
    rel = np.abs(np.asarray(got) - ref) / (np.abs(ref) + 1e-2 * np.abs(ref).max())
    assert np.median(rel) < 5e-3 and rel.max() < 8e-2, (np.median(rel), rel.max())


def _assert_alu_close(got, ref):
    ref = np.asarray(ref, np.float32)
    off = np.abs(np.asarray(got) - ref) > 1e-5 * np.abs(ref)
    assert off.mean() <= 5e-3, f"{off.sum()} lanes off"


def test_sizes_match_the_scripts():
    for ns, rounds in ((P1, overlap.K6_ROUNDS), (P2, overlap.K7_ROUNDS)):
        assert ns["LAYERS"] == overlap.LAYERS
        assert ns["VPU_ROUNDS"] == rounds
        assert ns["GRID"] * ns["B"] == overlap.LANES
    assert P2["LOOP"] == overlap.LOOP
    assert overlap.per_layer(overlap.K6_ROUNDS) == max(1, P1["VPU_ROUNDS"] // 7) == 4


def test_weights_match_the_scripts():
    model = overlap.probe_model()
    for k, w in zip(model.kernels, _weights()):
        assert torch.equal(k.float(), torch.from_numpy(np.asarray(w, np.float32).T.copy()))
    assert not any(b.any() for b in model.biases)


def test_chain_matches_mxu_chain():
    u = _lanes()
    ref = P1["_mxu_chain"](_feats(u), _weights())[0]
    _assert_chain_close(overlap.mxu_plain(overlap.probe_model(), torch.from_numpy(u)), ref)


def test_alu_matches_vpu_work():
    u = _lanes()
    for rounds in (1, overlap.K6_ROUNDS):
        _assert_alu_close(overlap.alu_plain(torch.from_numpy(u), rounds),
                          P1["_vpu_work"](jnp.asarray(u), rounds))
    _assert_alu_close(overlap.alu_round_plain(torch.from_numpy(u)),
                      P2["_vpu_round"](jnp.asarray(u)))


def test_both_matches_interleaved():
    u = _lanes()
    ref = P2["_interleaved"](jnp.asarray(u), _feats(u), _weights(),
                             overlap.per_layer(overlap.K6_ROUNDS))
    _assert_chain_close(overlap.both_plain(overlap.probe_model(), torch.from_numpy(u)), ref)


def _reference_loop(u, prng, state):
    """overlap_probe2.py::k_loop's body on the scripts' functions, with
    the port's Philox words in place of the TPU's generator."""
    ws = _weights()
    per = max(1, P2["VPU_ROUNDS"] // len(P2["LAYERS"]))
    lane = torch.arange(N, dtype=torch.int64)
    zero = torch.zeros_like(lane)
    acc = jnp.zeros((N,), jnp.float32)
    extras = tuple(jnp.asarray(u) * (1.0 + 0.01 * k) for k in range(12 if state else 1))
    for i in range(P2["LOOP"]):
        v = jnp.asarray(u) + acc * 1e-6
        if prng:
            bits = philox4x32_10([lane, zero + i, zero, zero], 7, 0)[0]
            v = v + jnp.asarray((bits >> 8).numpy().astype(np.float32)) * 1e-9
        r = P2["_interleaved"](v, _feats(v), ws, per)
        if state:
            extras = tuple(P2["_vpu_round"](e) + r * 1e-9 for e in extras)
        acc = acc + r
    return acc + sum(extras)


@pytest.mark.parametrize("variant", list(overlap.LOOP_VARIANTS))
def test_loop_matches_k_loop(variant):
    u = _lanes(3)
    prng, state = overlap.LOOP_VARIANTS[variant]
    got = overlap.overlap_loop(overlap.probe_model(), torch.from_numpy(u), variant)
    _assert_chain_close(got, _reference_loop(u, prng, state))


def test_k6_plan_and_slices():
    """The probe model's NifWg: the bf16 plan of its seven layers within a
    block's 227 KB (3 ring stages), and each layer's slices un-swizzle to
    the scripts' (out, in) weights exactly, every pad zero, biases zero."""
    model = overlap.probe_model()
    plan = nif_ops.wgmma_plan(model)
    net = nif_ops.wg_struct(model)
    assert plan["elem"] == 2 and plan["stages"] == 3 and plan["smem_bytes"] <= 232_448
    assert (net.int8, net.num_layers, net.smem_bytes) == (0, 7, plan["smem_bytes"])
    assert (net.max_v, *net.mean, net.log_flag) == (1.0, 0.0, 0.0, 0.0, 0)
    assert list(net.chunks[:7]) == [5, 5, 5, 5, 5, 5, 0]
    assert list(net.f_atoms[:7]) == [1, 0, 0, 1, 0, 0, 0]
    for lay, (slices, bias), w in zip(plan["layers"], nif_ops.wgmma_operands(model), _weights()):
        wt = np.asarray(w, np.float32)
        flat = _unswizzle(slices.float().numpy())
        fan_out, trunk, k_act = lay["fan_out"], lay["trunk"], 64 * lay["in_atoms"]
        np.testing.assert_array_equal(flat[:fan_out, :trunk], wt[:, :trunk])
        np.testing.assert_array_equal(flat[:fan_out, k_act:k_act + lay["fan_in"] - trunk],
                                      wt[:, trunk:])
        pad = np.ones_like(flat, dtype=bool)
        pad[:fan_out, :trunk] = False
        pad[:fan_out, k_act:k_act + lay["fan_in"] - trunk] = False
        assert not flat[pad].any() and not bias.any() and bias.shape == (lay["rows"],)


def _k6_tile(model, u):
    """K6's tile from its operands: every feature row of a lane holds
    bf16(u), the slices read in kernel order (trunk slices, then feature
    slices) with f32 sums, ReLU and bf16 between layers; row 0 of the
    head times 1 plus 0 (the probe's decode)."""
    plan = nif_ops.wgmma_plan(model)
    feats = torch.zeros((u.shape[0], 64 * plan["feat_atoms"]))
    feats[:, :4 * model.embedding_dim] = u.to(torch.bfloat16).float()[:, None]
    x = None
    for lay, (slices, bias) in zip(plan["layers"], nif_ops.wgmma_operands(model)):
        w = torch.from_numpy(_unswizzle(slices.float().numpy()))
        inputs = ([x[:, :64 * lay["in_atoms"]]] if lay["in_atoms"] else []) + (
            [feats] if lay["f_atoms"] else [])
        y = torch.cat(inputs, dim=1) @ w.t() + bias
        x = torch.relu(y).to(torch.bfloat16).float()
    return y[:, 0] * 1.0 + 0.0


@pytest.mark.parametrize("variant", ["mxu", "both"])
def test_k6_tile_matches_plain_and_scripts(variant):
    """The tile's model (plus the 28 ALU rounds for 'both') matches the
    plain version and the script's chain (_mxu_chain; _interleaved for
    'both') within the bf16 budget."""
    u = _lanes(5)
    model = overlap.probe_model()
    got = _k6_tile(model, torch.from_numpy(u))
    if variant == "mxu":
        plain = overlap.mxu_plain(model, torch.from_numpy(u))
        ref = P1["_mxu_chain"](_feats(u), _weights())[0]
    else:
        rounds = overlap.per_layer(overlap.K6_ROUNDS)
        got = got + overlap.alu_plain(torch.from_numpy(u), rounds * len(overlap.LAYERS))
        plain = overlap.both_plain(model, torch.from_numpy(u))
        ref = P2["_interleaved"](jnp.asarray(u), _feats(u), _weights(), rounds)
    _assert_chain_close(got, plain)
    _assert_chain_close(got, ref)


def _k7_tile(model, u, prng, state):
    """K7's tile: LOOP passes of K6's tile, the owning thread's carries in
    the kernel's order - v = u + acc 1e-6 (+ the Philox term), the chain
    over bf16(v), r = v after its ALU rounds + row 0, then each carry one
    ALU round plus r 1e-9, acc + r; out = acc + (carry 0 + carry 1 + ...)."""
    n = u.shape[0]
    lane = torch.arange(n, dtype=torch.int64)
    zero = torch.zeros_like(lane)
    rounds = overlap.per_layer(overlap.K7_ROUNDS) * len(overlap.LAYERS)
    extras = [u * np.float32(1.0 + 0.01 * k) for k in range(overlap.EXTRAS if state else 1)]
    acc = torch.zeros_like(u)
    for i in range(overlap.LOOP):
        v = u + acc * np.float32(1e-6)
        if prng:
            bits = philox4x32_10([lane, zero + i, zero, zero], 7, 0)[0]
            v = v + (bits >> 8).to(torch.float32) * np.float32(1e-9)
        r = overlap.alu_plain(v, rounds) + _k6_tile(model, v)
        if state:
            extras = [overlap.alu_round_plain(e) + r * np.float32(1e-9) for e in extras]
        acc = acc + r
    total = extras[0]
    for e in extras[1:]:
        total = total + e
    return acc + total


@pytest.mark.parametrize("variant", list(overlap.LOOP_VARIANTS))
def test_k7_tile_matches_plain_and_script(variant):
    """K7's loop on the tile's model matches the plain version (loop_plain)
    and the script's k_loop body within the bf16 budget, for each of the
    four variants."""
    u = _lanes(9)
    prng, state = overlap.LOOP_VARIANTS[variant]
    model = overlap.probe_model()
    got = _k7_tile(model, torch.from_numpy(u), prng, state)
    _assert_chain_close(got, overlap.loop_plain(model, torch.from_numpy(u), prng, state))
    _assert_chain_close(got, _reference_loop(u, prng, state))


def test_k6_launch_path_takes_a_nifwg(monkeypatch):
    """The chain probes' launchers - K6 'mxu' and 'both' and K7's 'loop' -
    get the probe model's NifWg (the wgmma tile) and refuse anything else;
    each C launcher takes the NifWg as its first argument."""
    model = overlap.probe_model()
    arg = overlap.chain_arg(model)
    assert isinstance(arg._obj, _lib.NifWg) and arg._obj.int8 == 0
    src = (Path(_lib.__file__).resolve().parent.parent / "csrc" / "probes.cu").read_text()
    for name in ("mxu", "both", "loop"):
        assert f'extern "C" int pt_probe_{name}(const pt::NifWg* wg,' in src
    monkeypatch.setattr(overlap, "wg_struct", lambda m: _lib.TraceParams())
    with pytest.raises(ValueError, match="NifWg"):
        overlap.chain_arg(model)


def test_cpu_wrappers_run_the_plain_versions():
    model = overlap.probe_model()
    u = torch.from_numpy(_lanes())
    before = (overlap.overlap_mxu.launches, overlap.overlap_alu.launches,
              overlap.overlap_both.launches, dict(overlap.overlap_loop.launches))
    assert torch.equal(overlap.overlap_mxu(model, u), overlap.mxu_plain(model, u))
    assert torch.equal(overlap.overlap_alu(u), overlap.alu_plain(u))
    assert torch.equal(overlap.overlap_both(model, u), overlap.both_plain(model, u))
    assert before == (overlap.overlap_mxu.launches, overlap.overlap_alu.launches,
                      overlap.overlap_both.launches, overlap.overlap_loop.launches)


def test_probe_main_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the check is for hosts without one")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        overlap.main()
