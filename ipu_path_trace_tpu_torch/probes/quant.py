"""K8: the precision probe - the NIF chain at int8 / fp8 against bf16.

Replaces ``scripts/quant_probe.py`` (``build_call``): the canonical 6x320
E=12 chain (+ head) over precomputed Fourier features of 1,105,920 rays
(540 blocks of 2048, the script's size), in six arithmetics:

  bf16          bf16 x bf16 -> f32 dots, f32 bias + ReLU, bf16 activations
  int8_requant  per-layer static scales, int32 accumulate, f32 epilogue,
                symmetric requant clip(round(y * inv), +-127); the skip
                layer runs as two dots (trunk, features), each with its scale
  int8_perchan  the same with per-output-channel weight scales: (out, 1)
                multipliers in place of the scalar
  int8_raw      int8 dots, a plain cast between layers (the script's
                optimistic bound: a wrong function by design)
  fp8_e4m3      e4m3 x e4m3 -> f32 dots, per-layer scales, cast back to e4m3
  fp8_raw       e4m3 dots, plain cast back (optimistic bound)

The narrow variants pad contraction dims to 32 (48 -> 64, 368 -> 384)
and the head to 8 rows, zero weights in the padding, as the script does.
Casts follow JAX, not PyTorch: f32 -> e4m3 rounds to nearest even and
gives NaN past 464 (PyTorch saturates at 448), f32 -> int8 truncates
toward zero and saturates (PyTorch wraps); ``to_e4m3`` and ``to_int8``
say so in code.

Each variant has a plain PyTorch version (``probe_plain``) and a kernel in
``csrc/quant_probe.cu``, templated on the variant, on the ``wgmma`` chains
of ``csrc/nif_wgmma.cuh`` (the slices of ``ops/nif.chain_slices``): bf16
(HGMMA), the three int8 variants (s8, IGMMA), fp8_e4m3 and fp8_raw exact
on bf16 (the e4m3 codes' bf16 values, HGMMA with f32 sums, as the plain
version sums; ``FP8_CHAIN``).  fp8 does not run on the card's fp8 MMA
(e4m3 ``wgmma``, QGMMA): its sums keep only part of their bits and break
the fp8 budget (PERF.md; ``probes/fp8_qgmma.py`` measures that route).
The wrapper ``quant_probe`` launches the kernel for CUDA operands and runs
the plain version for CPU ones, and counts its launches per variant.  The
host side (``build_operands``) is the script's numpy, so the operands
equal ``build_call``'s byte for byte.

    python -m ipu_path_trace_tpu_torch.probes.quant [--variants ...] [--iters N]

times each variant on the card and prints the script's lines
(ms per 1,105,920-ray sample, relative error against the f32 chain,
speedup against bf16; the fp8 lines name their chain, ``FP8_CHAIN``, so
that the ratio is not read as the fp8 tensor cores'), then one JSON line
of them with the card's nvidia-smi name and power limit.  The script's
``docs/QUANT.json`` is not written: the JSON line on stdout takes its
place.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys

import numpy as np
import torch

from ..ops import _lib
from ..ops.nif import chain_plan, chain_slices, pad_rows, wg_arg, wg_net
from ..utils.devtime import card_line, time_per_call

WIDTH, HEIGHT = 1104, 1000
BLOCK = 2048
EMBED = 12
FEAT = 4 * EMBED  # 48
HIDDEN = 320
SKIP = 3  # layer whose input concatenates the Fourier features
NLAYERS = 7  # 6 hidden + head
PAD = 32  # contraction padding of the narrow variants
RAYS = -(-WIDTH * HEIGHT // BLOCK) * BLOCK  # 1,105,920
VARIANTS = ("bf16", "int8_requant", "int8_perchan", "int8_raw", "fp8_e4m3", "fp8_raw")
# What the fp8 variants' kernel runs (csrc/quant_probe.cu ChainK8Wide), said
# beside their times: bf16 tensor-core arithmetic, not the fp8 rate.
FP8_CHAIN = "exact: e4m3 values on bf16 HGMMA"
E4M3_NAN_ABOVE = 464.0  # 448 + half its ulp: JAX's f32 -> e4m3 gives NaN past it


def chain_dims(pad_to: int | None = None):
    """[(in, out)] per layer; ``pad_to`` pads the contraction dims up and
    widens the head to 8 rows (scripts/quant_probe.py::chain_dims)."""
    rup = lambda x: x if pad_to is None else -(-x // pad_to) * pad_to  # noqa: E731
    dims = []
    cur = FEAT
    for i in range(6):
        inw = cur + FEAT if i == SKIP else cur
        dims.append((rup(inw), HIDDEN))
        cur = HIDDEN
    dims.append((rup(cur), 3 if pad_to is None else 8))
    return dims


def make_weights(rng: np.random.Generator, pad_to: int | None):
    """f32 (out, in) weights + (out, 1) biases, He-scaled; padded
    contraction columns are zero so every variant computes the same
    function (scripts/quant_probe.py::make_weights)."""
    ws, bs = [], []
    cur = FEAT
    for i, (inw, outw) in enumerate(chain_dims(pad_to)):
        real_in = (cur + FEAT) if i == SKIP else cur
        w = np.zeros((outw, inw), np.float32)
        w[:, :real_in] = rng.standard_normal(
            (outw, real_in), dtype=np.float32) * np.sqrt(2.0 / real_in)
        ws.append(w)
        bs.append(rng.standard_normal((outw, 1), dtype=np.float32) * 0.01)
        cur = outw if i < 6 else cur
    return ws, bs


def encode_np(u, v):
    """f32 Fourier features (4E, B) by the double-angle recurrence
    (scripts/quant_probe.py::encode_np)."""
    uu, vv = 2.0 * (u - 1.0), 2.0 * (v - 1.0)
    su, cu = np.sin(uu), np.cos(uu)
    sv, cv = np.sin(vv), np.cos(vv)
    sus, cus, svs, cvs = [su], [cu], [sv], [cv]
    for _ in range(EMBED - 1):
        s, c = sus[-1], cus[-1]
        sus.append(2.0 * s * c)
        cus.append(1.0 - 2.0 * s * s)
        s, c = svs[-1], cvs[-1]
        svs.append(2.0 * s * c)
        cvs.append(1.0 - 2.0 * s * s)
    return np.stack(sus + svs + cus + cvs, axis=0).astype(np.float32)


def f32_chain_np(ws, bs, feats):
    """The f32 chain on the host -> (out, B) and each layer's input
    activations, the calibration (scripts/quant_probe.py::f32_chain_np)."""
    x = feats
    inputs = []
    for i, (w, b) in enumerate(zip(ws, bs)):
        if i == SKIP:
            x = np.concatenate([x, feats], axis=0)
        if x.shape[0] < w.shape[1]:
            x = np.pad(x, ((0, w.shape[1] - x.shape[0]), (0, 0)))
        inputs.append(x)
        y = w @ x + b
        if i < len(ws) - 1:
            y = np.maximum(y, 0.0)
        x = y
    return x, inputs


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """f32 -> float8_e4m3fn as JAX casts: round to nearest even, NaN past
    464 (and for inf and NaN) with the input's sign, where PyTorch would
    saturate at 448."""
    x = x.float()
    nan = torch.copysign(torch.tensor(torch.nan, device=x.device), x)
    return torch.where(x.abs() <= E4M3_NAN_ABOVE, x, nan).to(torch.float8_e4m3fn)


def to_int8(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int8 as JAX casts: toward zero, saturating, NaN -> 0, where
    PyTorch would wrap."""
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.clamp(x, -128.0, 127.0).trunc().to(torch.int8)


# ------------------------------------------------------------ operands ----

@dataclasses.dataclass
class ProbeOperands:
    """One variant's device operands, as ``build_call`` hands them to the
    TPU kernel: ``feats`` (48, n) f32 (bf16) or (64, n) int8 / e4m3 codes;
    per layer the (out, in) weights (bf16, int8 or e4m3) and (out, 1) f32
    biases; ``scal`` (3L,) f32 [m_i, inv_i, mf_i] (the accumulator
    multiplier, the next layer's quant step, the skip dot's multiplier;
    None for bf16); ``int8_perchan``'s (out, 1) ``mults`` and skip
    ``mult_f``."""

    variant: str
    feats: torch.Tensor
    weights: list[torch.Tensor]
    biases: list[torch.Tensor]
    scal: torch.Tensor | None = None
    mults: list[torch.Tensor] | None = None
    mult_f: torch.Tensor | None = None
    # The kernel's NifWg and the tensors it points to (_kernel_net).
    _net: tuple | None = dataclasses.field(default=None, init=False, repr=False,
                                           compare=False)

    def to(self, device) -> "ProbeOperands":
        mv = lambda t: None if t is None else t.to(device)  # noqa: E731
        return ProbeOperands(self.variant, mv(self.feats), [mv(w) for w in self.weights],
                             [mv(b) for b in self.biases], mv(self.scal),
                             None if self.mults is None else [mv(m) for m in self.mults],
                             mv(self.mult_f))

    @property
    def device(self) -> torch.device:
        return self.feats.device


def input_absmax(inputs_np) -> list[float]:
    """Per-layer input-activation absmax of the calibration run."""
    return [max(1e-6, float(np.abs(a).max())) for a in inputs_np]


@functools.lru_cache(maxsize=2)
def calibration(pad_to: int | None, n: int = RAYS):
    """The script's inputs and f32 calibration run for one padding:
    (features, weights, biases, f32 output, per-layer input absmax).  A
    function of the script's seeds alone; the f32 chain over 1,105,920
    rays takes seconds of host BLAS, so it runs once per process."""
    feats = probe_inputs(n)
    ws, bs = make_weights(np.random.default_rng(3), pad_to)
    ref, inputs = f32_chain_np(ws, bs, feats)
    return feats, ws, bs, ref, input_absmax(inputs)


def build_operands(variant: str, ws_np, bs_np, feats_np, xmax) -> ProbeOperands:
    """The host half of ``build_call`` (scripts/quant_probe.py:259-323) in
    its own numpy: scales from the calibration run's absmax ``xmax``
    (``input_absmax``), quantised weights and features, padded to 32 on
    the contraction axis (CPU tensors)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {', '.join(VARIANTS)}")
    num_layers = len(ws_np)
    fmax = max(1e-6, float(np.abs(feats_np).max()))
    biases = [torch.from_numpy(np.asarray(b, np.float32)) for b in bs_np]
    feat_pad = -(-FEAT // PAD) * PAD
    if variant == "bf16":
        return ProbeOperands(variant, torch.from_numpy(np.asarray(feats_np, np.float32)),
                             [torch.from_numpy(w).to(torch.bfloat16) for w in ws_np], biases)
    if variant == "int8_perchan":
        sw = [np.maximum(np.abs(w).max(axis=1, keepdims=True), 1e-6) / 127.0
              for w in ws_np]  # (out, 1) per-channel
        sx = [m / 127.0 for m in xmax]
        sf = fmax / 127.0
        weights = [torch.from_numpy(np.clip(np.round(w / s), -127, 127)).to(torch.int8)
                   for w, s in zip(ws_np, sw)]
        mults = [torch.from_numpy(np.asarray(sw[i] * sx[i], np.float32))
                 for i in range(num_layers)]
        mult_f = torch.from_numpy(np.asarray(sw[SKIP] * sf, np.float32))
        scal = np.zeros((3 * num_layers,), np.float32)
        for i in range(num_layers):
            scal[3 * i + 1] = (1.0 / sx[i + 1]) if i + 1 < len(sx) else 1.0
        fq = np.clip(np.round(feats_np / sf), -127, 127)
        fq = np.pad(fq, ((0, feat_pad - FEAT), (0, 0)))
        return ProbeOperands(variant, torch.from_numpy(fq).to(torch.int8), weights, biases,
                             torch.from_numpy(scal), mults, mult_f)
    int_mode = variant.startswith("int8")
    qmax = 127.0 if int_mode else 224.0  # e4m3 max 448, keep headroom
    sw = [max(1e-6, float(np.abs(w).max())) / qmax for w in ws_np]
    sx = [m / qmax for m in xmax]
    sf = fmax / qmax
    if int_mode:
        weights = [torch.from_numpy(np.clip(np.round(w / s), -127, 127)).to(torch.int8)
                   for w, s in zip(ws_np, sw)]
    else:
        weights = [to_e4m3(torch.from_numpy(w / s)) for w, s in zip(ws_np, sw)]
    scal = np.zeros((3 * num_layers,), np.float32)
    for i in range(num_layers):
        scal[3 * i] = sw[i] * sx[i]
        scal[3 * i + 1] = (1.0 / sx[i + 1]) if i + 1 < len(sx) else 1.0
        scal[3 * i + 2] = sw[i] * sf
    fq = feats_np / sf
    if int_mode:
        fq = np.clip(np.round(fq), -127, 127)
    fq = torch.from_numpy(np.pad(fq, ((0, feat_pad - FEAT), (0, 0))))
    return ProbeOperands(variant, fq.to(torch.int8) if int_mode else to_e4m3(fq), weights,
                         biases, torch.from_numpy(scal))


# -------------------------------------------------------------- plain ----

def _dot(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(out, K) x (K, B) with f32 products and sums: exact for the int8
    codes (K * 127^2 < 2^24) and for the e4m3 and bf16 products."""
    if w.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the f32 dot would round")
    return w.float() @ x.float()


def _bf16_plain(ops: ProbeOperands) -> torch.Tensor:
    """scripts/quant_probe.py::_bf16_kernel -> (3, n) f32."""
    feats = ops.feats.to(torch.bfloat16)
    x = feats
    last = len(ops.weights) - 1
    for i, (w, b) in enumerate(zip(ops.weights, ops.biases)):
        if i == SKIP:
            x = torch.cat([x, feats], dim=0)
        y = _dot(w, x) + b
        if i < last:
            x = torch.relu(y).to(torch.bfloat16)
    return y


def _fma(a: torch.Tensor, m: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * m + c rounded once.  The product of two f32 values is exact in
    f64, so only the sum rounds before the cast back (twice, f64 then
    f32, which can differ from one rounding only when the f64 sum lands
    on an f32 tie: about once in 2^28 sums)."""
    return (a.double() * m.double() + c.double()).float()


def _narrow_plain(ops: ProbeOperands) -> torch.Tensor:
    """scripts/quant_probe.py::_narrow_kernel and ::_int8_perchan_kernel
    -> (8, n) f32, the f32 operations in the script's order and fused as
    XLA fuses them (the TPU kernel run in interpret mode, the reference
    the CPU tests hold this to): y = fma(acc, m, b), and at the skip layer
    y = fma(acc, m, accf * mf) + b."""
    v = ops.variant
    perchan = v == "int8_perchan"
    scal = ops.scal
    feats = ops.feats
    x = feats
    last = len(ops.weights) - 1
    for i, (w, b) in enumerate(zip(ops.weights, ops.biases)):
        m = ops.mults[i] if perchan else scal[3 * i]
        if i == SKIP:
            trunk = w.shape[1] - feats.shape[0]
            mf = ops.mult_f if perchan else scal[3 * i + 2]
            y = _fma(_dot(w[:, :trunk], x), m, _dot(w[:, trunk:], feats) * mf) + b
        else:
            y = _fma(_dot(w, x), m, b)
        if i == last:
            break
        y = torch.relu(y)
        if v in ("int8_requant", "int8_perchan"):
            x = torch.clamp(torch.round(y * scal[3 * i + 1]), -127.0, 127.0).to(torch.int8)
        elif v == "int8_raw":
            x = to_int8(y)
        elif v == "fp8_e4m3":
            x = to_e4m3(y * scal[3 * i + 1])
        else:
            x = to_e4m3(y)
    return y


def probe_plain(ops: ProbeOperands) -> torch.Tensor:
    """Plain PyTorch version of the K8 kernel -> (out_w, n) f32."""
    return _bf16_plain(ops) if ops.variant == "bf16" else _narrow_plain(ops)


# ------------------------------------------------------------- kernel ----

def _scales(ops: ProbeOperands) -> tuple[list, torch.Tensor | None, list | None]:
    """The narrow variants' (out,) accumulator multipliers per layer (the
    scalar m_i repeated where the script has one), the skip dot's (out,)
    multipliers and the quant steps; bf16 has none."""
    if ops.scal is None:
        return [None] * len(ops.weights), None, None
    scal = ops.scal.tolist()
    perchan = ops.variant == "int8_perchan"
    dev = ops.device
    mults = [ops.mults[i].reshape(-1) if perchan else torch.full((w.shape[0],), scal[3 * i],
                                                                  device=dev)
             for i, w in enumerate(ops.weights)]
    mf = (ops.mult_f.reshape(-1) if perchan
          else torch.full((HIDDEN,), scal[3 * SKIP + 2], device=dev))
    return mults, mf, [scal[3 * i + 1] for i in range(len(ops.weights))]


def probe_plan(ops: ProbeOperands) -> dict:
    """The wgmma chain's plan of a variant (ops/nif.chain_plan): the
    script's layers over its 48 (bf16) or 64 zero-padded feature rows, in
    2-byte operands (bf16; fp8: the e4m3 codes' bf16 values) or 1-byte ones
    (the int8 codes)."""
    dims = [(k, out, i == SKIP) for i, (out, k) in enumerate(w.shape for w in ops.weights)]
    return chain_plan(dims, ops.feats.shape[0], 1 if ops.variant.startswith("int8") else 2,
                      what=f"the precision probe's {ops.variant} chain")


def _kernel_net(ops: ProbeOperands) -> _lib.NifWg:
    """The kernel's view of the operands (csrc/quant_probe.cu), built once
    and cached on ``ops`` with the tensors it points to: a NifWg of
    ``probe_plan`` - the weights as swizzled slices (e4m3 codes as their
    bf16 values), biases and (narrow variants) multipliers padded to the
    rows, the skip dot's multipliers and the quant steps, the decode
    y * 1 + 0."""
    if ops._net is not None:
        return ops._net[0]
    mults, mf, inv = _scales(ops)
    biases = [b.reshape(-1).float().contiguous() for b in ops.biases]
    plan = probe_plan(ops)
    wide = lambda w: (w.float().to(torch.bfloat16)  # noqa: E731
                      if w.dtype == torch.float8_e4m3fn else w)
    operands = [(chain_slices(lay, wide(w)), pad_rows(b, lay["rows"]))
                for lay, w, b in zip(plan["layers"], ops.weights, biases)]
    scales = None
    if ops.variant != "bf16":
        scales = ([pad_rows(m, lay["rows"]) for lay, m in zip(plan["layers"], mults)],
                  pad_rows(mf, HIDDEN), inv)
    net = wg_net(plan, operands, EMBED, False, 1.0, (0.0, 0.0, 0.0), scales)
    ops._net = (net, (operands, scales))
    return net


def kernel_arg(ops: ProbeOperands):
    """The launcher's chain argument: the variant's NifWg (``wg_arg``
    refuses anything else)."""
    return wg_arg(_kernel_net(ops))


def _check_operands(ops: ProbeOperands) -> None:
    """The kernel takes the script's chain: these shapes and code types."""
    dims = chain_dims(None if ops.variant == "bf16" else PAD)
    code = (torch.bfloat16 if ops.variant == "bf16" else
            torch.int8 if ops.variant.startswith("int8") else torch.float8_e4m3fn)
    if ([tuple(w.shape) for w in ops.weights] != [(o, i) for i, o in dims]
            or any(w.dtype != code for w in ops.weights) or ops.feats.shape[0] != dims[0][0]
            or ops.feats.dtype != (torch.float32 if ops.variant == "bf16" else code)):
        raise ValueError(f"quant probe {ops.variant}: operands are not the 6x320 E=12 chain "
                         "of build_operands")


def quant_probe(ops: ProbeOperands) -> torch.Tensor:
    """The chain over ``ops.feats`` -> (3, n) f32 for bf16, (8, n) for the
    narrow variants.  The kernel for CUDA operands, the plain version for
    CPU ones."""
    _check_operands(ops)
    if ops.device.type == "cpu":
        return probe_plain(ops)
    dev = _lib.require_cuda(f"quant probe {ops.variant}", ops.feats, *ops.weights, *ops.biases)
    rows, n = ops.feats.shape
    out = torch.empty((3 if ops.variant == "bf16" else 8, n), dtype=torch.float32, device=dev)
    err = _lib.library().pt_quant_probe(kernel_arg(ops), VARIANTS.index(ops.variant),
                                        _lib.ptr(ops.feats), rows, n, _lib.ptr(out),
                                        _lib.stream(dev))
    _lib.check(err, f"quant probe {ops.variant}")
    quant_probe.launches[ops.variant] += 1
    return out


quant_probe.launches = dict.fromkeys(VARIANTS, 0)


# ------------------------------------------------------------- timing ----

def probe_inputs(n: int = RAYS):
    """The script's inputs: (u, v) from default_rng(7), their features."""
    rng = np.random.default_rng(7)
    u = rng.random(n).astype(np.float32)
    v = rng.random(n).astype(np.float32)
    return encode_np(u, v)


def main(argv=None) -> dict:
    """Time each variant at the script's size on the card; print the
    script's lines and one JSON line; returns the per-variant results."""
    ap = argparse.ArgumentParser(prog="quant_probe")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=0,
                    help="timed iterations (0 = auto for a >= 5 s window)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("quant probe: CUDA is not available; the probe times the card")
    dev = torch.device("cuda", 0)
    card = card_line(dev)
    print(f"device: {torch.cuda.get_device_name(dev)} ({card})", file=sys.stderr)
    results = {"device": torch.cuda.get_device_name(dev), "card": card, "rays": RAYS,
               "block": BLOCK, "arch": "6x320 E=12 (+head)", "variants": {}}
    base_ms = None
    for variant in args.variants.split(","):
        variant = variant.strip()
        feats, ws, bs, ref, xmax = calibration(None if variant == "bf16" else PAD)
        ops = build_operands(variant, ws, bs, feats, xmax).to(dev)
        out = quant_probe(ops)
        step_s = time_per_call(lambda: quant_probe(ops), 1, dev)
        iters = args.iters or max(5, int(5.0 / max(step_s, 1e-3)))
        ms = time_per_call(lambda: quant_probe(ops), iters, dev) * 1e3
        out_h = out.cpu().numpy()[: ref.shape[0]]
        rel = float(np.abs(out_h - ref).max() / np.abs(ref).max())
        entry = {"ms_per_sample": ms, "rel_err_vs_f32": rel}
        if variant == "bf16":
            base_ms = ms
        if base_ms:
            entry["speedup_vs_bf16"] = base_ms / ms
        if variant.startswith("fp8"):  # bf16 tensor-core arithmetic: say so beside the ratio
            entry["chain"] = FP8_CHAIN
        results["variants"][variant] = entry
        print(f"{variant}: {ms:.3f} ms/sample  rel_err={rel:.2e}"
              + (f"  ({base_ms / ms:.2f}x bf16)" if base_ms else "")
              + (f"  [{entry['chain']}]" if "chain" in entry else ""), flush=True)
    print(json.dumps({"quant_probe": results["variants"], "card": card}), flush=True)
    return results


if __name__ == "__main__":
    main()
