"""K8, the precision probe of the PyTorch port (probes/quant.py), against
the script it ports (scripts/quant_probe.py).

The script's TPU kernel runs here in Pallas interpret mode, at 512 rays
in blocks of 256: ``pl.pallas_call`` with ``interpret=True`` and the
script's ``BLOCK`` set to 256, both restored after each run.  Evidence:

* the host functions (chain_dims, make_weights, encode_np, f32_chain_np)
  equal the script's bit for bit;
* the operands (quantised weights and features, biases, scales and the
  per-channel multipliers) equal build_call's byte for byte;
* each variant's plain version against build_call's kernel: the int8
  variants bit for bit (the integer dots are exact, and the epilogue is
  fused as XLA fuses it: fma(acc, m, b)); bf16 to median 5e-3 and max
  8e-2 relative error floored at 1% of the peak (the reference's bf16
  budget: the dots sum in another order, and a bf16 activation can round
  the other way); fp8 to median 1e-3, fewer than 1% of lanes above 1e-2
  and max 0.5 (the f32 sums of e4m3 products round in another order, and
  a requantised code can move by one step);
* the f32 -> e4m3 and f32 -> int8 casts against ``jnp.astype`` on edge
  values (overflow, ties, NaN).
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ipu_path_trace_tpu_torch.probes import quant

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "quant_probe.py"
N, BLOCK = 512, 256
_spec = importlib.util.spec_from_file_location("quant_probe_script", SCRIPT)
qp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(qp)
_PALLAS_CALL = pl.pallas_call


def _case(variant):
    """(weights, biases, f32 output, layer inputs) of the variant's padding."""
    ws, bs = quant.make_weights(np.random.default_rng(3), None if variant == "bf16" else 32)
    return (ws, bs, *quant.f32_chain_np(ws, bs, FEATS))


def _operands(variant):
    ws, bs, _, inputs = _case(variant)
    return quant.build_operands(variant, ws, bs, FEATS, quant.input_absmax(inputs))


FEATS = quant.probe_inputs(N)


@functools.cache
def _script_run(variant):
    """build_call in interpret mode -> (its operands by name, the device
    features, the kernel's output)."""
    ws, bs, _, inputs = _case(variant)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qp.pl, "pallas_call", functools.partial(_PALLAS_CALL, interpret=True))
        mp.setattr(qp, "BLOCK", BLOCK)
        run, feats_dev = qp.build_call(variant, ws, bs, FEATS, inputs, N)
        out = np.asarray(run(feats_dev), np.float32)
    fn = run.__wrapped__
    closure = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    return closure, feats_dev, out


def _bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).tobytes()


def _rel(got, ref):
    return np.abs(got - ref) / (np.abs(ref) + 1e-2 * np.abs(ref).max())


def test_host_functions_match_the_script():
    rng = np.random.default_rng(5)
    u, v = rng.random(N).astype(np.float32), rng.random(N).astype(np.float32)
    np.testing.assert_array_equal(quant.encode_np(u, v), qp.encode_np(u, v))
    for pad in (None, 32):
        assert quant.chain_dims(pad) == qp.chain_dims(pad)
        ws, bs = quant.make_weights(np.random.default_rng(3), pad)
        ws0, bs0 = qp.make_weights(np.random.default_rng(3), pad)
        for a, b in zip(ws + bs, ws0 + bs0):
            assert a.dtype == b.dtype and _bytes(a) == _bytes(b)
        out, inputs = quant.f32_chain_np(ws, bs, FEATS)
        out0, inputs0 = qp.f32_chain_np(ws0, bs0, FEATS)
        assert _bytes(out) == _bytes(out0)
        assert [_bytes(a) for a in inputs] == [_bytes(a) for a in inputs0]
    assert (quant.WIDTH, quant.HEIGHT, quant.BLOCK) == (qp.WIDTH, qp.HEIGHT, qp.BLOCK)
    assert quant.RAYS == 540 * 2048 == 1_105_920
    assert quant.NLAYERS == qp.NLAYERS == len(quant.chain_dims())
    assert (quant.EMBED, quant.FEAT, quant.HIDDEN, quant.SKIP) == (qp.EMBED, qp.FEAT, qp.HIDDEN,
                                                                   qp.SKIP)
    feats, ws, bs, ref, xmax = quant.calibration(32, N)
    out0, inputs0 = qp.f32_chain_np(*qp.make_weights(np.random.default_rng(3), 32), FEATS)
    assert _bytes(feats) == _bytes(FEATS) and _bytes(ref) == _bytes(out0)
    assert xmax == [max(1e-6, float(np.abs(a).max())) for a in inputs0]


@pytest.mark.parametrize("variant", quant.VARIANTS)
def test_operands_match_build_call(variant):
    closure, feats_dev, _ = _script_run(variant)
    ops = _operands(variant)
    assert _bytes(ops.feats) == _bytes(feats_dev)
    assert [_bytes(w) for w in ops.weights] == [_bytes(w) for w in closure["weights"]]
    assert [_bytes(b) for b in ops.biases] == [_bytes(b) for b in closure["biases"]]
    if variant == "bf16":
        assert ops.scal is None and not closure["extra"]
        return
    (scal,) = closure["extra"]
    assert _bytes(ops.scal) == _bytes(np.asarray(scal).reshape(-1))
    if variant == "int8_perchan":
        tail = closure["tail"]
        assert [_bytes(m) for m in ops.mults] == [_bytes(m) for m in tail[:-1]]
        assert _bytes(ops.mult_f) == _bytes(tail[-1])
    else:
        assert ops.mults is None and not closure["tail"]


@pytest.mark.parametrize("variant", quant.VARIANTS)
def test_plain_matches_build_call(variant):
    _, _, ref = _script_run(variant)
    ops = _operands(variant)
    got = quant.probe_plain(ops).numpy()
    assert got.shape == ref.shape == ((3 if variant == "bf16" else 8), N)
    assert np.isfinite(got).all()
    if variant.startswith("int8"):
        np.testing.assert_array_equal(got, ref)
        return
    rel = _rel(got, ref)
    if variant == "bf16":
        assert np.median(rel) < 5e-3 and rel.max() < 8e-2, (np.median(rel), rel.max())
    else:
        assert np.median(rel) < 1e-3 and (rel > 1e-2).mean() < 0.01 and rel.max() < 0.5, (
            np.median(rel), (rel > 1e-2).mean(), rel.max())


def test_relative_errors_against_f32_chain():
    """The probe's quality signal: the faithful variants track the f32
    chain, the raw ones (the script's optimistic bounds) do not."""
    rel = {}
    for variant in quant.VARIANTS:
        ref = _case(variant)[2]
        got = quant.probe_plain(_operands(variant)).numpy()
        rel[variant] = np.abs(got[:3] - ref[:3]).max() / np.abs(ref).max()
    assert rel["bf16"] < 2e-2 and rel["int8_perchan"] < rel["int8_requant"] < 0.1
    assert rel["fp8_e4m3"] < 0.2
    assert rel["int8_raw"] > 0.5 and rel["fp8_raw"] > 0.5


EDGES = [0.0, -0.0, 1e-9, 2.0 ** -10, 1.5 * 2.0 ** -10, 2.0 ** -9, 0.3, 447.9, 448.0, 455.9, 456.0,
         460.0, 463.99, 464.0, 464.01, 470.0, 479.9, 480.0, 500.0, 1e6, np.inf, -np.inf, np.nan,
         -464.0, -464.5, -300.7]


def test_e4m3_cast_matches_jax():
    x = np.array(EDGES, np.float32)
    got = quant.to_e4m3(torch.from_numpy(x)).float().numpy()
    ref = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).astype(np.float32)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(ref))
    assert np.isnan(got[x == 500.0]).all()  # where PyTorch's own cast gives 448


def test_int8_cast_matches_jax():
    x = np.array([0.0, 0.7, -0.7, 1.5, 2.5, 126.9, 127.5, 128.0, 300.7, -200.0, -128.9, np.inf,
                  -np.inf, np.nan], np.float32)
    got = quant.to_int8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(x).astype(jnp.int8)))
    assert got[x == 300.7][0] == 127  # where PyTorch's own cast wraps


@pytest.mark.parametrize("variant", quant.VARIANTS)
def test_kernel_operands_layout(variant):
    """The NifNet the kernel reads: (round8(out), K) weight rows, the skip
    layer's trunk/feature split, the multipliers and quant steps."""
    ops = _operands(variant)
    net = quant._kernel_net(ops)
    assert net is quant._kernel_net(ops)  # built once per operands
    narrow = variant != "bf16"
    assert (net.num_layers, net.embed_dim, net.max_width, net.int8) == (7, 12, 320, int(narrow))
    assert net.max_v == 1.0 and list(net.mean) == [0.0] * 3 and net.log_flag == 0
    kdims = [(64, 320), (320, 320), (320, 320), (384, 320), (320, 320), (320, 320), (320, 8)]
    if not narrow:
        kdims = [(48, 320), (320, 320), (320, 320), (368, 320), (320, 320), (320, 320), (320, 3)]
    for i, (k, out) in enumerate(kdims):
        assert (net.fan_in[i], net.fan_out[i], net.k_pad[i]) == (k, out, k)
        assert net.skip[i] == int(i == quant.SKIP)
        assert net.k_trunk[i] == (320 if i == quant.SKIP else k)
    _, keep = ops._net
    heads = [t for t in keep if t.data_ptr() == net.w[6]]
    assert len(heads) == 1 and heads[0].shape == (8, 320)  # the bf16 head padded to 8 rows
    assert all(bool(net.mult[i]) == narrow for i in range(7)) and bool(net.mult_skip) == narrow
    if narrow:
        assert list(net.inv_next)[:7] == ops.scal.tolist()[1::3]
        for i in range(7):
            (m,) = [t for t in keep if t.data_ptr() == net.mult[i]]
            want = ops.mults[i].reshape(-1) if variant == "int8_perchan" else ops.scal[3 * i]
            assert m.shape == (kdims[i][1],) and torch.equal(m, want.expand_as(m))


def test_cpu_wrapper_runs_the_plain_version():
    before = dict(quant.quant_probe.launches)
    for variant in quant.VARIANTS:
        ops = _operands(variant)
        assert torch.equal(quant.quant_probe(ops), quant.probe_plain(ops))
    assert quant.quant_probe.launches == before


def test_wrapper_rejects_other_operands():
    ops = _operands("int8_requant")
    for bad in (dataclasses.replace(ops, variant="fp8_e4m3"),
                dataclasses.replace(ops, feats=ops.feats[:48]),
                dataclasses.replace(ops, weights=ops.weights[:-1])):
        with pytest.raises(ValueError, match="not the 6x320"):
            quant.quant_probe(bad)


def test_probe_main_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the check is for hosts without one")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        quant.main([])
