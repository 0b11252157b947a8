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
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
