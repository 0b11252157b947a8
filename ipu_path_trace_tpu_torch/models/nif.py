"""Neural Image Field (NIF): metadata, keras-HDF5 weights, and inference.

Counterpart of ``ipu_path_trace_tpu/models/nif.py``.  The loaders are
numpy-only (the weights are read by models/hdf5.py); the network is an ``nn.Module`` whose weights are
buffers (the port only serves, so nothing needs gradients).

The math is the reference's: uv' = 2 (uv - 1); features
[sin(u 2^j) | sin(v 2^j) | cos(u 2^j) | cos(v 2^j)] for j < E; dense
layers with relu and a skip-concat of the features detected from the
layer shapes; decode y = x * max + mean (eps folded into mean), exp()
when log-tone-mapped.  bf16 weights multiply with f32 accumulation and
activations are rounded to bf16 after each relu.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class NifMetaData:
    """Parsed nif_metadata.txt."""

    embedding_dimension: int
    name: str
    image_shape: tuple[int, ...]
    eps: float
    log_tone_map: bool
    max: float
    mean: np.ndarray  # (3,) f32, eps already folded in when log-tone-mapped
    hidden_size: int

    @staticmethod
    def load(path: str) -> "NifMetaData":
        with open(path) as f:
            pt = json.load(f)
        enc = pt["encode_params"]
        mean = np.asarray(enc["mean"], np.float32).copy()
        eps = float(enc["eps"])
        log_tone_map = bool(enc["log_tone_map"])
        if log_tone_map:
            mean -= eps  # fold the inverse eps into the mean
        hidden = 0
        cmd = pt.get("train_command", [])
        for i, tok in enumerate(cmd):
            if tok == "--layer-size" and i + 1 < len(cmd):
                hidden = int(cmd[i + 1])
        return NifMetaData(
            embedding_dimension=int(pt["embedding_dimension"]),
            name=str(pt.get("name", "")),
            image_shape=tuple(int(x) for x in pt["original_image_shape"]),
            eps=eps,
            log_tone_map=log_tone_map,
            max=float(enc["max"]),
            mean=mean,
            hidden_size=hidden,
        )


@dataclasses.dataclass
class NifLayer:
    name: str
    kernel: np.ndarray  # (in, out)
    bias: np.ndarray | None
    activation: str  # "relu" | "none"
    dtype: str  # "float16" | "float32"


@dataclasses.dataclass
class NifWeights:
    """Host-side model description."""

    layers: list[NifLayer]

    @staticmethod
    def load_h5(path: str) -> "NifWeights":
        """Load a keras-saved .h5: Dense layers only; InputLayer and
        Concatenate entries are skipped (the skip-concat is re-detected
        from the layer shapes), any other class is an error.  Read with
        the numpy-only models/hdf5.py (no h5py needed)."""
        from .hdf5 import File

        layers: list[NifLayer] = []
        f = File(path)
        cfg = f.attrs["model_config"]
        if isinstance(cfg, bytes):
            cfg = cfg.decode("utf-8")
        for entry in json.loads(cfg)["config"]["layers"]:
            cls = entry["class_name"]
            if cls in ("InputLayer", "Concatenate"):
                continue
            if cls != "Dense":
                raise ValueError(f"Layer class '{cls}' not supported by NIF loader.")
            lcfg = entry["config"]
            name = lcfg["name"]
            kernel = f[f"/model_weights/{name}/{name}/kernel:0"]
            bias = None
            if lcfg.get("use_bias", True):
                bias = f[f"/model_weights/{name}/{name}/bias:0"]
            act = lcfg.get("activation", "linear")
            layers.append(NifLayer(
                name=name, kernel=kernel, bias=bias,
                activation="none" if act == "linear" else act,
                dtype=str(lcfg.get("dtype", "float32")),
            ))
        if not layers:
            raise ValueError(f"No Dense layers found in '{path}'.")
        return NifWeights(layers)


class NifModel(nn.Module):
    """The NIF MLP: per layer a kernel (in, out) and a bias (out,) buffer
    in the compute dtype (bf16 by default), plus f32 decode constants.

    Kernels keep the reference's (in, out) layout, which is also the
    layout the CUDA kernels stream: the outputs a thread computes for one
    input row are contiguous.
    """

    def __init__(self, kernels, biases, max_value: float, mean, log_tone_map: bool):
        super().__init__()
        if len(kernels) != len(biases) or not kernels:
            raise ValueError("need one bias per kernel and at least one layer")
        self.num_layers = len(kernels)
        for i, (w, b) in enumerate(zip(kernels, biases)):
            self.register_buffer(f"kernel_{i}", w.contiguous())
            self.register_buffer(f"bias_{i}", b.contiguous())
        self.max = float(np.float32(max_value))
        self.mean = tuple(float(m) for m in np.asarray(mean, np.float32))
        self.log_tone_map = bool(log_tone_map)

    @property
    def kernels(self) -> list[torch.Tensor]:
        return [getattr(self, f"kernel_{i}") for i in range(self.num_layers)]

    @property
    def biases(self) -> list[torch.Tensor]:
        return [getattr(self, f"bias_{i}") for i in range(self.num_layers)]

    @property
    def dtype(self) -> torch.dtype:
        return self.kernel_0.dtype

    @property
    def device(self) -> torch.device:
        return self.kernel_0.device

    @property
    def embedding_dim(self) -> int:
        return self.kernel_0.shape[0] // 4

    def layer_plan(self) -> list[tuple[int, int, bool]]:
        """(in, out, skip) per layer; skip = the layer reads its trunk
        input concatenated with the Fourier features (detected from the
        shapes like the reference)."""
        feat = 4 * self.embedding_dim
        plan, cur = [], feat
        for i, w in enumerate(self.kernels):
            fan_in, fan_out = w.shape
            skip = i > 0 and fan_in != cur
            if skip and fan_in != cur + feat:
                raise ValueError(
                    f"layer {i} input {fan_in} is neither {cur} nor the "
                    f"skip-concat width {cur + feat}")
            plan.append((fan_in, fan_out, skip))
            cur = fan_out
        return plan

    def forward(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return nif_apply(self, u, v)


def make_params(weights: NifWeights, meta: NifMetaData,
                dtype: torch.dtype = torch.bfloat16, device="cpu") -> NifModel:
    """Build the model; hidden layers must be relu and the output linear."""
    for i, l in enumerate(weights.layers):
        is_last = i == len(weights.layers) - 1
        allowed = ("none", "linear", "") if is_last else ("relu",)
        if (l.activation or "none") not in allowed:
            raise ValueError(
                f"Unsupported activation '{l.activation}' on layer {l.name!r} "
                "(hidden layers must be relu; output linear)")
    kernels = [torch.from_numpy(l.kernel.astype(np.float32)).to(dtype)
               for l in weights.layers]
    biases = [torch.from_numpy((l.bias if l.bias is not None
                                else np.zeros(l.kernel.shape[1])).astype(np.float32)).to(dtype)
              for l in weights.layers]
    return NifModel(kernels, biases, meta.max, meta.mean, meta.log_tone_map).to(device)


def load_nif_assets(asset_dir: str, dtype: torch.dtype = torch.bfloat16,
                    device="cpu") -> tuple[NifModel, NifMetaData, NifWeights]:
    """Load an assets dir: nif_metadata.txt + converted.hdf5."""
    meta = NifMetaData.load(f"{asset_dir}/nif_metadata.txt")
    weights = NifWeights.load_h5(f"{asset_dir}/converted.hdf5")
    return make_params(weights, meta, dtype, device), meta, weights


def params_from_jax(jax_params, device="cpu") -> NifModel:
    """The reference's ``NifParams`` as a NifModel.

    Takes each array through ``np.asarray(...).astype(np.float32)``;
    bf16 -> f32 -> bf16 is exact, so both packages hold the same weights.
    """
    dtype = (torch.bfloat16 if str(jax_params.kernels[0].dtype) == "bfloat16"
             else torch.float32)

    def conv(a):
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(dtype)

    return NifModel(
        [conv(k) for k in jax_params.kernels],
        [conv(b) for b in jax_params.biases],
        float(np.asarray(jax_params.max)),
        np.asarray(jax_params.mean, np.float32),
        bool(np.asarray(jax_params.log_tone_map)),
    ).to(device)


def fourier_features(u: torch.Tensor, v: torch.Tensor, embedding_dim: int) -> torch.Tensor:
    """(P, 4E) positional encoding with the direct sin/cos of each octave."""
    coeffs = torch.tensor([2.0 ** j for j in range(embedding_dim)],
                          dtype=torch.float32, device=u.device)
    pos_u = (2.0 * (u - 1.0))[..., None] * coeffs
    pos_v = (2.0 * (v - 1.0))[..., None] * coeffs
    return torch.cat([torch.sin(pos_u), torch.sin(pos_v),
                      torch.cos(pos_u), torch.cos(pos_v)], dim=-1)


def nif_apply(model: NifModel, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """NIF inference for a batch of (u, v) -> (P, 3) f32, network order.

    Operands are upcast to f32 before each product: bf16 products are
    exact in f32, so this is the bf16-in / f32-accumulate arithmetic of
    the reference (a bf16 CPU matmul would round its accumulator).
    """
    dtype = model.dtype
    feats = fourier_features(u, v, model.embedding_dim).to(dtype)
    x = feats
    last = model.num_layers - 1
    for i, (w, b) in enumerate(zip(model.kernels, model.biases)):
        if x.shape[-1] != w.shape[0]:
            x = torch.cat([x, feats], dim=-1)
        x = x.float() @ w.float() + b.float()
        if i != last:
            x = torch.relu(x).to(dtype)
    y = x.float() * model.max + torch.tensor(model.mean, device=x.device)
    return torch.exp(y) if model.log_tone_map else y


def analyse_nif(weights: NifWeights, sample_count: int) -> dict:
    """FLOP and parameter-size report of the network."""
    flops = 0
    param_bytes = 0
    for l in weights.layers:
        itemsize = 2 if l.dtype == "float16" else 4
        param_bytes += l.kernel.size * itemsize
        fan_in, fan_out = l.kernel.shape
        flops += 2 * fan_in * fan_out
        if l.bias is not None:
            param_bytes += l.bias.size * itemsize
            flops += l.bias.shape[0]
    return {
        "layers": len(weights.layers),
        "hidden_size": weights.layers[0].kernel.shape[1],
        "batch_size": sample_count,
        "flops": flops * sample_count,
        "parameters_kib": param_bytes / 1024.0,
    }
