"""The plain reference's neural environment light (NIF).

Reads an asset directory itself (``nif_metadata.txt`` and the keras-style
``converted.hdf5``, through the frozen reader ``hdf5_read``) and
evaluates the network at escaped directions: equirect (u, v) of the
direction, Fourier features [sin(2^j u') | sin(2^j v') | cos(2^j u') |
cos(2^j v')] of u' = 2 (u - 1), dense layers with relu and the
skip-concat of the features where a layer's fan-in asks for it, and the
decode y = x * max + mean (exp when log-tone-mapped), in network (bgr)
order.

``precision`` picks the arithmetic:

- "bf16": the configuration's chain.  Weights rounded to bf16, products
  of bf16 values summed in f32 (TF32 off), the features and each hidden
  activation rounded to bf16.
- "fp8": the control, one step below: the same with every operand of
  every product rounded to e4m3 under a scale (per tensor for a weight,
  per lane for an activation, amax / 448).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from .geometry import Vec3, equirect_uv
from .hdf5_read import File

PRECISIONS = ("bf16", "fp8")
_E4M3_MAX = 448.0


class Nif(NamedTuple):
    kernels: list  # (in, out) f32 tensors holding the stated type's values
    biases: list  # (out,) f32
    embedding_dim: int
    max: float
    mean: tuple
    log_tone_map: bool

    def widths(self) -> list[list[int]]:
        return [list(k.shape) for k in self.kernels]


def _fp8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _amax_scale(x: torch.Tensor, dim=None) -> torch.Tensor:
    a = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    return torch.clamp_min(a, 1e-30) / _E4M3_MAX


def load_nif(asset_dir: str, precision: str = "bf16", device="cpu") -> Nif:
    """The asset's network in ``precision``'s weights."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown reference precision {precision!r} ({', '.join(PRECISIONS)})")
    with open(os.path.join(asset_dir, "nif_metadata.txt")) as f:
        meta = json.load(f)
    enc = meta["encode_params"]
    log_tone_map = bool(enc["log_tone_map"])
    mean = np.asarray(enc["mean"], np.float32).copy()
    if log_tone_map:
        mean -= np.float32(enc["eps"])  # the inverse eps folded into the mean
    h5 = File(os.path.join(asset_dir, "converted.hdf5"))
    cfg = h5.attrs["model_config"]
    cfg = cfg.decode() if isinstance(cfg, bytes) else cfg
    kernels, biases = [], []
    dense = [e["config"] for e in json.loads(cfg)["config"]["layers"]
             if e["class_name"] == "Dense"]
    for i, layer in enumerate(dense):
        name = layer["name"]
        act = layer.get("activation", "linear")
        if act != ("linear" if i == len(dense) - 1 else "relu"):
            raise ValueError(f"layer {name}: activation {act!r} is not the NIF's")
        w = h5[f"/model_weights/{name}/{name}/kernel:0"].astype(np.float32)
        b = (h5[f"/model_weights/{name}/{name}/bias:0"].astype(np.float32)
             if layer.get("use_bias", True) else np.zeros(w.shape[1], np.float32))
        w = torch.from_numpy(w).to(torch.bfloat16).to(torch.float32)
        b = torch.from_numpy(b).to(torch.bfloat16).to(torch.float32)
        if precision == "fp8":
            w = _fp8(w, _amax_scale(w))
        kernels.append(w.to(device))
        biases.append(b.to(device))
    return Nif(kernels, biases, int(meta["embedding_dimension"]), float(np.float32(enc["max"])),
               tuple(float(m) for m in mean), log_tone_map)


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return _fp8(x, _amax_scale(x, dim=-1))


def nif_apply(nif: Nif, u: torch.Tensor, v: torch.Tensor, precision: str = "bf16") -> torch.Tensor:
    """(P, 3) decoded output in network order at equirect (u, v)."""
    coeffs = (1 << torch.arange(nif.embedding_dim, device=u.device)).to(torch.float32)
    pos_u = (2.0 * (u - 1.0))[..., None] * coeffs
    pos_v = (2.0 * (v - 1.0))[..., None] * coeffs
    feats = torch.cat([torch.sin(pos_u), torch.sin(pos_v), torch.cos(pos_u), torch.cos(pos_v)],
                      dim=-1).to(torch.bfloat16).to(torch.float32)
    x = feats
    last = len(nif.kernels) - 1
    for i, (w, b) in enumerate(zip(nif.kernels, nif.biases)):
        if x.shape[-1] != w.shape[0]:
            x = torch.cat([x, feats], dim=-1)
        if precision != "bf16":
            x = _round(x, precision)
        x = x @ w + b
        if i != last:
            x = _round(torch.relu(x), "bf16")
    y = x * nif.max + torch.tensor(nif.mean, device=x.device)
    return torch.exp(y) if nif.log_tone_map else y


def env_light(nif: Nif, esc_dir: Vec3, esc_w: Vec3, escaped: torch.Tensor, azimuth: float,
              precision: str = "bf16") -> Vec3:
    """The env light each lane's escape brings back (zero where none)."""
    n = esc_dir.x.shape[0]
    out = torch.zeros((n, 3), dtype=torch.float32, device=esc_dir.x.device)
    idx = torch.nonzero(escaped & (esc_dir.norm2() > 0.5)).squeeze(1)
    if idx.numel():
        u, v = equirect_uv(Vec3(*(c[idx] for c in esc_dir)), azimuth)
        out[idx] = nif_apply(nif, u, v, precision)
    return Vec3(esc_w.x * out[:, 2], esc_w.y * out[:, 1], esc_w.z * out[:, 0])
