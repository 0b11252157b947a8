"""K2 and K4: the NIF kernels - env shade of escaped rays, and the NIF at (u, v).

``nif_env_shade`` replaces ``ipu_path_trace_tpu/ops/nif_pallas.py::
nif_env_shade_pallas``: equirect (u, v) of each escape direction, the NIF
chain, the bgr -> rgb flip and the product with the escape weights, in
one kernel.  ``nif_apply_t`` replaces ``nif_apply_pallas_t``: the NIF at
given (u, v), (3, P) f32 in network channel order (``eval_env`` and the
baked env mode call it).  Both live in ``csrc/nif.cu``; the chain itself
is ``csrc/nif_dev.cuh``: the bf16 chain for a ``NifModel``, the int8
chain (K5, ``_quant_mlp_core``) for a ``QuantNifModel``.  Each wrapper
launches its kernel for CUDA tensors and runs its ``*_plain`` version for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.envmap import equirect_uv
from ..core.vecmath import Vec3
from ..models.nif import NifModel, nif_apply
from ..models.quant import QuantNifModel, nif_apply_quant
from . import _lib


def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def _cached(model: NifModel, attr: str, tensors, build):
    """``build()`` once per model, device and weight version."""
    key = (model.device, tuple((t.data_ptr(), t._version) for t in tensors))
    cached = getattr(model, attr, None)
    if cached is None or cached[0] != key:
        cached = (key, build())
        setattr(model, attr, cached)
    return cached[1]


def _pack(model: NifModel, dtype: torch.dtype, k_mult: int) -> list[tuple]:
    """Per layer (packed weights, k_trunk, k_pad): (round8(out), k_pad)
    rows, one per output - the trunk inputs zero-padded to k_trunk =
    round(trunk, k_mult), then (skip layer) the Fourier-feature inputs
    zero-padded to k_mult on their own.  Zero padding leaves every dot
    product unchanged."""
    feat = 4 * model.embedding_dim
    out = []
    for (fan_in, fan_out, skip), w in zip(model.layer_plan(), model.kernels):
        trunk = fan_in - feat if skip else fan_in
        k_trunk = _round(trunk, k_mult)
        k_pad = k_trunk + (_round(feat, k_mult) if skip else 0)
        packed = torch.zeros((_round(fan_out, 8), k_pad), dtype=dtype, device=w.device)
        packed[:fan_out, :trunk] = w[:trunk].t()
        if skip:
            packed[:fan_out, k_trunk:k_trunk + feat] = w[trunk:].t()
        out.append((packed, k_trunk, k_pad))
    return out


def kernel_operands(model: NifModel) -> list[tuple[torch.Tensor, torch.Tensor, int, int]]:
    """bf16 chain, per layer (packed weights, f32 bias, k_trunk, k_pad):
    bf16 rows with K padded to 16 - the B-fragment layout of the bf16
    ``mma.sync`` in csrc/nif_dev.cuh::nif_tile.  Cached on the model."""
    def build():
        return [(packed, b.float().contiguous(), k_trunk, k_pad) for (packed, k_trunk, k_pad), b
                in zip(_pack(model, torch.bfloat16, 16), model.biases)]

    return _cached(model, "_kernel_operands", model.kernels, build)


def quant_kernel_operands(model: QuantNifModel) -> list[tuple]:
    """int8 chain, per layer (packed int8 weights, f32 bias, f32 mults,
    k_trunk, k_pad): int8 rows with K padded to 32, the s8 ``mma.sync``'s
    K (and the TPU's int8 tile; ops/nif_pallas.py::pack_quant_operands),
    the skip layer's trunk and feature columns padded separately because
    they are two dots with two multipliers.  Cached on the model."""
    def build():
        return [(packed, b.contiguous(), m.contiguous(), k_trunk, k_pad)
                for (packed, k_trunk, k_pad), b, m
                in zip(_pack(model, torch.int8, 32), model.biases, model.mults)]

    return _cached(model, "_quant_kernel_operands", model.kernels + model.mults, build)


def net_struct(model: NifModel) -> _lib.NifNet:
    """The kernel's view of the model: per-layer shapes, skip flags and
    pointers to the packed operands (kept alive by the model's cache)."""
    plan = model.layer_plan()
    if len(plan) > _lib.NIF_MAX_LAYERS:
        raise ValueError(f"NIF has {len(plan)} layers; the kernel takes at most "
                         f"{_lib.NIF_MAX_LAYERS}")
    quant = isinstance(model, QuantNifModel)
    if not quant and model.dtype != torch.bfloat16:
        raise ValueError(f"the NIF kernels run the bf16 or the int8 chain; model is "
                         f"{model.dtype}")
    net = _lib.NifNet()
    net.num_layers = len(plan)
    net.embed_dim = model.embedding_dim
    net.max_width = max([1] + [fo for _, fo, _ in plan[:-1]])
    net.log_flag = int(model.log_tone_map)
    net.int8 = int(quant)
    if quant:
        ops = quant_kernel_operands(model)
        net.mult_skip = model.mult_skip.data_ptr()
        for i, ((_, _, m, _, _), inv) in enumerate(zip(ops, model.inv_next.tolist())):
            net.mult[i] = m.data_ptr()
            net.inv_next[i] = inv
        ops = [(w, b, k_trunk, k_pad) for w, b, _, k_trunk, k_pad in ops]
    else:
        ops = kernel_operands(model)
    for i, ((fan_in, fan_out, skip), (w, b, k_trunk, k_pad)) in enumerate(zip(plan, ops)):
        net.fan_in[i], net.fan_out[i], net.skip[i] = fan_in, fan_out, int(skip)
        net.k_trunk[i], net.k_pad[i] = k_trunk, k_pad
        net.w[i], net.b[i] = w.data_ptr(), b.data_ptr()
    net.max_v = model.max
    for c in range(3):
        net.mean[c] = model.mean[c]
    return net


def model_tensors(model: NifModel) -> list[torch.Tensor]:
    extra = model.mults + [model.mult_skip] if isinstance(model, QuantNifModel) else []
    return model.kernels + model.biases + extra


def _chain_plain(model: NifModel, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(P, 3) decoded NIF output, network order: the int8 or the bf16 chain."""
    if isinstance(model, QuantNifModel):
        return nif_apply_quant(model, u, v)
    return nif_apply(model, u, v)


def equirect_from_dir(esc_dir: Vec3, azimuth: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Equirect (u, v); non-escaped lanes (zero directions) give (0, 0)."""
    escaped = esc_dir.norm2() > 0.5
    u, v = equirect_uv(esc_dir, azimuth)
    zero = torch.zeros_like(u)
    return torch.where(escaped, u, zero), torch.where(escaped, v, zero)


def nif_apply_t_plain(model: NifModel, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the NIF-at-(u, v) kernel -> (3, P) f32."""
    if u.is_cuda:
        nif_apply_t_plain.cuda_runs += 1
    return _chain_plain(model, u, v).t()


nif_apply_t_plain.cuda_runs = 0


def nif_apply_t(model: NifModel, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The NIF at (u, v) ((P,) f32 each) -> (3, P) f32, network channel
    order.  The kernel for CUDA tensors, the plain version for CPU."""
    if u.device.type == "cpu":
        return nif_apply_t_plain(model, u, v)
    u = u.float().contiguous()
    v = v.float().contiguous()
    dev = _lib.require_cuda("nif apply", u, v, *model_tensors(model))
    n = u.shape[0]
    if v.shape != (n,):
        raise ValueError("nif apply: u and v must be (P,)")
    net = net_struct(model)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    err = _lib.library().pt_nif_apply(ctypes.byref(net), _lib.ptr(u), _lib.ptr(v), n,
                                      _lib.ptr(out), _lib.stream(dev))
    _lib.check(err, "nif apply")
    nif_apply_t.launches += 1
    return out


nif_apply_t.launches = 0


def nif_env_shade_plain(model: NifModel, esc_dir: Vec3, esc_w: Vec3, azimuth: float) -> Vec3:
    """Plain PyTorch version of the env-shade kernel -> RGB contribution."""
    if esc_dir.x.is_cuda:
        nif_env_shade_plain.cuda_runs += 1
    u, v = equirect_from_dir(esc_dir, azimuth)
    out = _chain_plain(model, u, v)  # (P, 3) network (bgr) order
    return Vec3(esc_w.x * out[:, 2], esc_w.y * out[:, 1], esc_w.z * out[:, 0])


nif_env_shade_plain.cuda_runs = 0


def nif_env_shade(model: NifModel, esc_dir: Vec3, esc_w: Vec3, azimuth: float) -> Vec3:
    """Escaped-ray env shade -> Vec3 RGB radiance contribution.

    ``esc_dir``/``esc_w`` are (P,) f32 components, zero where the ray did
    not escape.  The kernel for CUDA tensors, the plain version for CPU.
    """
    if esc_dir.x.device.type == "cpu":
        return nif_env_shade_plain(model, esc_dir, esc_w, azimuth)
    escd = esc_dir.stack().float().contiguous()
    escw = esc_w.stack().float().contiguous()
    dev = _lib.require_cuda("env shade", escd, escw, *model_tensors(model))
    n = escd.shape[1]
    net = net_struct(model)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    err = _lib.library().pt_env_shade(ctypes.byref(net), _lib.ptr(escd), _lib.ptr(escw),
                                      float(azimuth), n, _lib.ptr(out), _lib.stream(dev))
    _lib.check(err, "env shade")
    nif_env_shade.launches += 1
    return Vec3.unstack(out)


nif_env_shade.launches = 0
