"""K6 and K7: do the NIF chain's tensor-core products overlap ALU work?

Replaces ``scripts/overlap_probe.py`` (K6: the chain alone, the ALU chain
alone, both interleaved in one kernel) and ``scripts/overlap_probe2.py``
(K7: the interleaved pair in a 16-iteration loop inside the kernel, with
in-kernel Philox draws, with twelve more live carries, and with both).
The kernels are ``csrc/probes.cu``; each wrapper launches its kernel for
a CUDA tensor and runs its ``*_plain`` version for a CPU tensor.  The
scripts' sizes are kept: 270 x 4096 lanes, the seven layers of ``LAYERS``,
30 ALU rounds in K6 and 28 in K7.

    python -m ipu_path_trace_tpu_torch.probes.overlap    # on a CUDA GPU

prints the scripts' lines: milliseconds per kernel call (K6) or per loop
iteration (K7) for each variant, and for K6 the serial prediction (A + B)
and the overlap prediction (max(A, B)) beside the measured time.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from ..models.nif import NifModel, mlp_chain
from ..ops import _lib
from ..ops.nif import model_tensors, net_struct
from ..ops.trace import philox4x32_10
from ..utils.devtime import card_line, time_per_call

LANES = 270 * 4096  # the scripts' GRID x B: about one 1104x1000 frame
LAYERS = [(320, 48), (320, 320), (320, 320), (320, 368), (320, 320), (320, 320), (3, 320)]
K6_ROUNDS = 30  # overlap_probe.py VPU_ROUNDS
K7_ROUNDS = 28  # overlap_probe2.py VPU_ROUNDS
LOOP = 16  # overlap_probe2.py LOOP
EXTRAS = 12  # live carries of the "+state" variants
LOOP_VARIANTS = {"loop": (False, False), "loop+prng": (True, False),
                 "loop+state": (False, True), "loop+both": (True, True)}


def per_layer(rounds: int) -> int:
    """ALU rounds after each layer of the interleaved chain."""
    return max(1, rounds // len(LAYERS))


def probe_model(device="cpu") -> NifModel:
    """The scripts' weights, (out, in) f16 normals times 0.05 rounded to
    bf16, as a NifModel ((in, out) kernels) with zero biases and the
    identity decode, which the CUDA chain then runs as it is."""
    kernels = []
    for i, (o, i_) in enumerate(LAYERS):
        w = np.random.default_rng(i).normal(size=(o, i_)).astype(np.float16) * 0.05
        kernels.append(torch.from_numpy(w.astype(np.float32).T.copy()).to(torch.bfloat16))
    biases = [torch.zeros(o, dtype=torch.bfloat16) for o, _ in LAYERS]
    return NifModel(kernels, biases, 1.0, np.zeros(3, np.float32), False).to(device)


# ------------------------------------------------------------- plain ----

def alu_round_plain(x: torch.Tensor) -> torch.Tensor:
    x = torch.sin(x) * 1.1 + torch.sqrt(torch.abs(x) + 0.3)
    return torch.where(x > 1.0, x * 0.5, x + 0.25)


def alu_plain(u: torch.Tensor, rounds: int = K6_ROUNDS) -> torch.Tensor:
    """Plain version of the ALU kernel (overlap_probe.py::_vpu_work)."""
    x = u
    for _ in range(rounds):
        x = alu_round_plain(x)
    return x


def mxu_plain(model: NifModel, u: torch.Tensor) -> torch.Tensor:
    """Plain version of the chain kernel: row 0 of the chain over 4E
    feature rows that all hold bf16(u) (overlap_probe.py::k_mxu)."""
    feats = u.to(model.dtype)[:, None].expand(-1, 4 * model.embedding_dim)
    return mlp_chain(model, feats)[:, 0]


def both_plain(model: NifModel, u: torch.Tensor, rounds: int = K6_ROUNDS) -> torch.Tensor:
    """Plain version of the interleaved kernel: the two chains are
    independent, so the interleave changes no value (k_both)."""
    return mxu_plain(model, u) + alu_plain(u, per_layer(rounds) * len(LAYERS))


def loop_plain(model: NifModel, u: torch.Tensor, prng: bool, state: bool,
               iters: int = LOOP, rounds: int = K7_ROUNDS) -> torch.Tensor:
    """Plain version of the loop kernel (overlap_probe2.py::k_loop)."""
    n = u.shape[0]
    lane = torch.arange(n, dtype=torch.int64, device=u.device)
    zero = torch.zeros_like(lane)
    acc = torch.zeros_like(u)
    extras = [u * (1.0 + 0.01 * k) for k in range(EXTRAS if state else 1)]
    for i in range(iters):
        v = u + acc * 1e-6
        if prng:
            bits = philox4x32_10([lane, zero + i, zero, zero], 7, 0)[0]
            v = v + (bits >> 8).to(torch.float32) * 1e-9
        r = alu_plain(v, per_layer(rounds) * len(LAYERS)) + mxu_plain(model, v)
        if state:
            extras = [alu_round_plain(e) + r * 1e-9 for e in extras]
        acc = acc + r
    return acc + sum(extras)


# ----------------------------------------------------------- kernels ----

def _launch(name: str, u: torch.Tensor, model: NifModel | None, *args) -> torch.Tensor:
    tensors = [u] + ([] if model is None else model_tensors(model))
    dev = _lib.require_cuda(f"probe {name}", *tensors)
    if u.dtype != torch.float32 or u.dim() != 1:
        raise ValueError(f"probe {name}: u must be (P,) float32")
    out = torch.empty_like(u)
    lib = _lib.library()
    n = u.shape[0]
    if model is None:
        err = lib.pt_probe_alu(_lib.ptr(u), n, *args, _lib.ptr(out), _lib.stream(dev))
    else:
        net = net_struct(model)
        fn = getattr(lib, f"pt_probe_{name}")
        err = fn(ctypes.byref(net), _lib.ptr(u), n, *args, _lib.ptr(out), _lib.stream(dev))
    _lib.check(err, f"probe {name}")
    return out


def overlap_mxu(model: NifModel, u: torch.Tensor) -> torch.Tensor:
    """K6 'mxu only': the chain's row 0 per lane."""
    if u.device.type == "cpu":
        return mxu_plain(model, u)
    out = _launch("mxu", u, model)
    overlap_mxu.launches += 1
    return out


def overlap_alu(u: torch.Tensor, rounds: int = K6_ROUNDS) -> torch.Tensor:
    """K6 'vpu only': ``rounds`` ALU rounds per lane."""
    if u.device.type == "cpu":
        return alu_plain(u, rounds)
    out = _launch("alu", u, None, rounds)
    overlap_alu.launches += 1
    return out


def overlap_both(model: NifModel, u: torch.Tensor, rounds: int = K6_ROUNDS) -> torch.Tensor:
    """K6 'both': the chain with per_layer(rounds) ALU rounds after each
    layer; row 0 + the ALU value."""
    if u.device.type == "cpu":
        return both_plain(model, u, rounds)
    out = _launch("both", u, model, per_layer(rounds))
    overlap_both.launches += 1
    return out


def overlap_loop(model: NifModel, u: torch.Tensor, variant: str = "loop") -> torch.Tensor:
    """K7: LOOP iterations of the interleaved pair in one kernel;
    ``variant`` is a key of LOOP_VARIANTS."""
    prng, state = LOOP_VARIANTS[variant]
    if u.device.type == "cpu":
        return loop_plain(model, u, prng, state)
    out = _launch("loop", u, model, per_layer(K7_ROUNDS), LOOP, int(prng), int(state))
    overlap_loop.launches[variant] += 1
    return out


overlap_mxu.launches = overlap_alu.launches = overlap_both.launches = 0
overlap_loop.launches = dict.fromkeys(LOOP_VARIANTS, 0)


# ------------------------------------------------------------ timing ----

def main() -> dict:
    """Time every variant at the scripts' size on the card and print the
    scripts' lines; returns the milliseconds (per call for K6, per loop
    iteration for K7)."""
    if not torch.cuda.is_available():
        raise SystemExit("overlap probe: CUDA is not available; the probe times the card")
    dev = torch.device("cuda", 0)
    card = card_line(dev)
    print(f"overlap probes on {card}, {LANES} lanes", flush=True)
    model = probe_model(dev)
    u = torch.linspace(0.0, 1.0, LANES, dtype=torch.float32, device=dev)
    ms = {}
    # overlap_probe.py: 3 timed runs of 8 calls each.
    for name, fn in (("mxu only", lambda: overlap_mxu(model, u)),
                     ("vpu only", lambda: overlap_alu(u)),
                     ("both", lambda: overlap_both(model, u))):
        ms[name] = time_per_call(fn, 24, dev) * 1e3
        print(f"{name:12s} {ms[name]:8.2f} ms/iter", flush=True)
    a, b, c = ms["mxu only"], ms["vpu only"], ms["both"]
    print(f"serial prediction={a + b:.2f}  overlap prediction={max(a, b):.2f}  "
          f"measured={c:.2f}", flush=True)
    # overlap_probe2.py: 3 timed runs of one LOOP-iteration call each.
    for variant in LOOP_VARIANTS:
        ms[variant] = time_per_call(lambda: overlap_loop(model, u, variant), 3, dev) * 1e3 / LOOP
        print(f"{variant:14s} {ms[variant]:8.2f} ms/iter", flush=True)
    print(json.dumps({"overlap_probe_ms": ms, "card": card}), flush=True)
    return ms


if __name__ == "__main__":
    main()
