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
  values (overflow, ties, NaN);
* what the kernel (csrc/quant_probe.cu, every variant on the wgmma tiles
  of csrc/nif_wgmma.cuh) is given: a NifWg of probe_plan; for fp8 the
  e4m3 codes' bf16 values in the bf16 slice image, and for the QGMMA
  routes that probes/fp8_qgmma.py rebuilds and measures, the codes in the
  8-bit one; independent numpy formulas of the 128- and 64-byte swizzles
  un-swizzle both to the script's weights exactly; a CPU model of the fp8
  tile from either's slices (f32 dots, each layer in its plan's passes of
  128 outputs, the script's epilogue) equals the plain version bit for bit
  and build_call within the fp8 budget above (the QGMMA routes' narrower
  tensor-core sums are not modelled: they are measured on the card); the
  launch path refuses any other struct; and the cuBLAS fp8 chain of
  probes/fp8_qgmma.py computes the plain version's function.
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

from test_torch_int8_wgmma import _unswizzle8
from test_torch_nif_wgmma import _unswizzle

from ipu_path_trace_tpu_torch.ops import _lib
from ipu_path_trace_tpu_torch.probes import fp8_qgmma, quant

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


def _assert_fp8_close(got, ref):
    """The fp8 budget against build_call (module docstring)."""
    rel = _rel(got, ref)
    assert np.median(rel) < 1e-3 and (rel > 1e-2).mean() < 0.01 and rel.max() < 0.5, (
        np.median(rel), (rel > 1e-2).mean(), rel.max())


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
    if variant == "bf16":
        rel = _rel(got, ref)
        assert np.median(rel) < 5e-3 and rel.max() < 8e-2, (np.median(rel), rel.max())
    else:
        _assert_fp8_close(got, ref)


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
    """What the kernel reads, every variant on the wgmma tiles: a NifWg of probe_plan - the script's layers over 48
    (bf16) or 64 (int8 and e4m3 codes) feature rows, the skip layer's
    trunk/feature split (the int8 skip layer in three passes of up to 128
    outputs), the weights as swizzled slices (bf16, the int8 codes, the
    e4m3 codes' bf16 values), the head padded to 8 rows, for the narrow
    variants the multipliers padded to the rows (the scalar m_i repeated
    where the script has one), the skip dot's multipliers and the quant
    steps, the decode y * 1 + 0."""
    ops = _operands(variant)
    net = quant._kernel_net(ops)
    assert net is quant._kernel_net(ops)  # built once per operands
    narrow = variant != "bf16"
    assert net.max_v == 1.0 and list(net.mean) == [0.0] * 3 and net.log_flag == 0
    kdims = [(64, 320), (320, 320), (320, 320), (384, 320), (320, 320), (320, 320), (320, 8)]
    if not narrow:
        kdims = [(48, 320), (320, 320), (320, 320), (368, 320), (320, 320), (320, 320), (320, 3)]
    scal = None if ops.scal is None else ops.scal.tolist()
    int8 = variant.startswith("int8")
    assert isinstance(net, _lib.NifWg) and net.int8 == int(int8)
    assert quant.kernel_arg(ops)._obj is net
    plan = quant.probe_plan(ops)
    assert [(lay["fan_in"], lay["fan_out"]) for lay in plan["layers"]] == kdims
    assert [lay["trunk"] for lay in plan["layers"]] == [0, 320, 320, 320, 320, 320, 320]
    assert [lay["f_atoms"] for lay in plan["layers"]] == [1, 0, 0, 1, 0, 0, 0]
    assert [lay["passes"] for lay in plan["layers"]] == [1, 1, 1, 3 if int8 else 1, 1, 1, 1]
    assert (net.num_layers, net.stages, net.smem_bytes) == (7, plan["stages"], plan["smem_bytes"])
    operands, scales = ops._net[1]
    assert [net.w[i] for i in range(7)] == [w.data_ptr() for w, _ in operands]
    assert all(w.dtype == (torch.int8 if int8 else torch.bfloat16) for w, _ in operands)
    head, bias = operands[6]
    assert head.shape == (5, 8, 64) and bias.shape == (8,)  # the head padded to 8 rows
    assert torch.equal(bias[:kdims[6][1]], ops.biases[6].reshape(-1))
    if not narrow:
        assert scales is None and not any(net.mult[:7])
        return
    mults, mf, inv = scales
    assert inv == scal[1::3]
    assert list(net.inv_next)[:7] == scal[1::3] and net.mult_skip == mf.data_ptr()
    assert torch.equal(mf, (ops.mult_f.reshape(-1) if variant == "int8_perchan"
                            else ops.scal[3 * quant.SKIP + 2].expand(320)))
    for i, m in enumerate(mults):
        assert net.mult[i] == m.data_ptr() and m.shape == (plan["layers"][i]["rows"],)
        want = (ops.mults[i].reshape(-1) if variant == "int8_perchan"
                else ops.scal[3 * i].expand(kdims[i][1]))
        assert torch.equal(m[:kdims[i][1]], want) and not m[kdims[i][1]:].any()
        assert net.b[i] == operands[i][1].data_ptr()


FP8 = [v for v in quant.VARIANTS if v.startswith("fp8")]
ROUTES = ("exact", *fp8_qgmma.ROUTES)  # the port's kernel, then the measured QGMMA routes


def _route_operands(ops, route):
    """(NifWg, plan, [(slices, bias)], scales) of the port's fp8 kernel
    ("exact") or of a QGMMA route of probes/fp8_qgmma.py."""
    if route == "exact":
        net = quant._kernel_net(ops)
        return (net, quant.probe_plan(ops), *ops._net[1])
    net, (plan, operands, scales) = fp8_qgmma.qgmma_net(ops, route)
    return net, plan, operands, scales


def _weights_of(slices: torch.Tensor) -> np.ndarray:
    """A layer's slices un-swizzled to (rows, K) values: bf16 (the port's
    kernel) under the 128-byte swizzle, e4m3 bytes (QGMMA) under the
    64-byte one."""
    if slices.dtype == torch.bfloat16:
        return _unswizzle(slices.float().numpy())
    codes = _unswizzle8(slices.view(torch.uint8).numpy())
    return torch.from_numpy(codes).view(torch.float8_e4m3fn).float().numpy()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("variant", FP8)
def test_e4m3_slices_unswizzle_to_the_weights(variant, route):
    """Each layer's slices - the port kernel's bf16 values, the QGMMA
    routes' e4m3 bytes - un-swizzled by an independent formula recover the
    script's e4m3 (out, in) weights exactly: the trunk slices its trunk
    columns, the feature slices (layer 0 and the skip layer) the feature
    columns, with every pad zero; the biases padded likewise."""
    closure, _, _ = _script_run(variant)
    _, plan, operands, _ = _route_operands(_operands(variant), route)
    for lay, (slices, bias), w, b in zip(plan["layers"], operands, closure["weights"],
                                         closure["biases"]):
        n_slices = lay["in_atoms"] + lay["f_atoms"]
        assert slices.dtype == (torch.bfloat16 if route == "exact" else torch.float8_e4m3fn)
        assert slices.is_contiguous() and slices.shape == (n_slices, lay["rows"], 64)
        assert slices.numel() * slices.element_size() == n_slices * lay["slice_bytes"]
        flat = _weights_of(slices)
        wt = np.asarray(w).astype(np.float32)
        fan_out, trunk, k_act = lay["fan_out"], lay["trunk"], 64 * lay["in_atoms"]
        np.testing.assert_array_equal(flat[:fan_out, :trunk], wt[:, :trunk])
        np.testing.assert_array_equal(flat[:fan_out, k_act:k_act + lay["fan_in"] - trunk],
                                      wt[:, trunk:])
        pad = np.ones_like(flat, dtype=bool)
        pad[:fan_out, :trunk] = False
        pad[:fan_out, k_act:k_act + lay["fan_in"] - trunk] = False
        assert not flat[pad].any()
        assert bias.shape == (lay["rows"],) and not bias[fan_out:].any()
        np.testing.assert_array_equal(bias[:fan_out].numpy(), np.asarray(b).reshape(-1))


def _fp8_tile(ops, route) -> torch.Tensor:
    """The fp8 tile's arithmetic from its operands: per layer the slices
    un-swizzled and read in kernel order - activation slices, then feature
    slices - as f32 dots of the codes' values, each layer in its plan's
    passes of 128 outputs (the skip layer's a trunk and a feature dot); the
    script's epilogue (fma as XLA fuses it) and the variant's next e4m3
    code.  Returns the head's (8, B) f32."""
    net, plan, operands, (mults, mult_skip, inv_next) = _route_operands(ops, route)
    assert isinstance(net, _lib.NifWg) and net.int8 == int(route != "exact")
    assert list(net.passes)[:7] == [lay["passes"] for lay in plan["layers"]]
    feats, x = ops.feats, None
    for i, (lay, (slices, bias)) in enumerate(zip(plan["layers"], operands)):
        w = torch.from_numpy(_weights_of(slices))
        k_act = 64 * lay["in_atoms"]
        y = torch.empty((lay["rows"], feats.shape[1]), dtype=torch.float32)
        for p in range(lay["passes"]):
            out = slice(128 * p, min(lay["rows"], 128 * (p + 1)) if lay["passes"] > 1
                        else lay["rows"])
            m, b = mults[i][out, None], bias[out, None]
            if k_act and lay["f_atoms"]:  # the skip layer: two dots
                acc, accf = quant._dot(w[out, :k_act], x), quant._dot(w[out, k_act:], feats)
                y[out] = quant._fma(acc, m, accf * mult_skip[out, None]) + b
            else:
                y[out] = quant._fma(quant._dot(w[out], x if k_act else feats), m, b)
        if lay["chunks"] == 0:
            return y
        y = torch.relu(y)
        x = quant.to_e4m3(y * inv_next[i] if ops.variant == "fp8_e4m3" else y)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("variant", FP8)
def test_k8_fp8_tile_matches_probe_plain(variant, route):
    """The fp8 tile's model, from the route's packed slices and plan,
    equals the plain version bit for bit on all eight head rows, and
    build_call (interpret mode) within the fp8 budget."""
    ops = _operands(variant)
    got = _fp8_tile(ops, route)
    assert torch.equal(got, quant.probe_plain(ops))
    _assert_fp8_close(got.numpy(), _script_run(variant)[2])


def test_launch_path_refuses_a_nifnet():
    """The launcher's chain argument is the variant's NifWg, fp8 included
    (the mma.sync chain of the old fp8 kernel is gone); any other struct
    raises, and a QGMMA route exists for the fp8 variants alone."""
    for variant in quant.VARIANTS:
        assert isinstance(quant.kernel_arg(_operands(variant))._obj, _lib.NifWg)
    ops = _operands("fp8_e4m3")
    ops._net = (_lib.TraceParams(), None)
    with pytest.raises(ValueError, match="NifWg"):
        quant.kernel_arg(ops)
    for variant, route in (("int8_raw", "qgmma"), ("fp8_raw", "exact")):
        with pytest.raises(ValueError, match="no route"):
            fp8_qgmma.qgmma_net(_operands(variant), route)


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


@pytest.mark.parametrize("variant", FP8)
def test_scaled_mm_yardstick_equals_the_plain_chain(variant):
    """probes/fp8_qgmma.py's torch._scaled_mm chain with the script's
    epilogue (what the card's fp8 tensor cores give for the fp8 function)
    computes the plain version's function: on the CPU, whose fp8 products
    sum in f32, it equals probe_plain bit for bit, with either
    accumulation."""
    ops = _operands(variant)
    for fast in (True, False):
        assert torch.equal(fp8_qgmma.scaled_mm_chain(ops, fast), quant.probe_plain(ops))


def test_fp8_qgmma_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the check is for hosts without one")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        fp8_qgmma.main()
