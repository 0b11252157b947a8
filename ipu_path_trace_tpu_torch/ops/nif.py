"""K2: the env-shade kernel - escaped rays through the NIF env light.

Replaces ``ipu_path_trace_tpu/ops/nif_pallas.py::nif_env_shade_pallas``:
equirect (u, v) of each escape direction, the NIF chain, the bgr -> rgb
flip and the product with the escape weights, in one kernel
(``csrc/nif.cu``; the chain itself is ``csrc/nif_dev.cuh``).
``nif_env_shade`` launches it for CUDA tensors and runs
``nif_env_shade_plain`` for CPU tensors.  The int8 chain is not ported
(ROADMAP queue 2, K5).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.envmap import equirect_uv
from ..core.vecmath import Vec3
from ..models.nif import NifModel, nif_apply
from . import _lib


def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_operands(model: NifModel) -> list[tuple[torch.Tensor, torch.Tensor, int, int]]:
    """Per layer the kernel's (packed weights, f32 bias, k_trunk, k_pad).

    Packed weights are bf16 (round8(out), k_pad) rows, one per output:
    the trunk inputs zero-padded to k_trunk = round16(trunk), then (skip
    layer) the Fourier-feature inputs zero-padded to 16 - the B-fragment
    layout of csrc/nif_dev.cuh.  Zero padding leaves every dot product
    unchanged.  Built once per model and device and cached on the model.
    """
    key = (model.device, tuple((w.data_ptr(), w._version) for w in model.kernels))
    cached = getattr(model, "_kernel_operands", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    feat = 4 * model.embedding_dim
    ops = []
    for (fan_in, fan_out, skip), w, b in zip(model.layer_plan(), model.kernels, model.biases):
        trunk = fan_in - feat if skip else fan_in
        k_trunk = _round(trunk, 16)
        k_pad = k_trunk + (_round(feat, 16) if skip else 0)
        packed = torch.zeros((_round(fan_out, 8), k_pad), dtype=torch.bfloat16,
                             device=w.device)
        packed[:fan_out, :trunk] = w[:trunk].t()
        if skip:
            packed[:fan_out, k_trunk:k_trunk + feat] = w[trunk:].t()
        ops.append((packed, b.float().contiguous(), k_trunk, k_pad))
    model._kernel_operands = (key, ops)
    return ops


def net_struct(model: NifModel) -> _lib.NifNet:
    """The kernel's view of the model: per-layer shapes, skip flags and
    pointers to the packed operands (kept alive by the model's cache)."""
    plan = model.layer_plan()
    if len(plan) > _lib.NIF_MAX_LAYERS:
        raise ValueError(f"NIF has {len(plan)} layers; the kernel takes at most "
                         f"{_lib.NIF_MAX_LAYERS}")
    if model.dtype != torch.bfloat16:
        raise ValueError(f"the NIF kernels run the bf16 chain; model is {model.dtype}")
    net = _lib.NifNet()
    net.num_layers = len(plan)
    net.embed_dim = model.embedding_dim
    net.max_width = max([1] + [fo for _, fo, _ in plan[:-1]])
    net.log_flag = int(model.log_tone_map)
    for i, ((fan_in, fan_out, skip), (w, b, k_trunk, k_pad)) in enumerate(
            zip(plan, kernel_operands(model))):
        net.fan_in[i], net.fan_out[i], net.skip[i] = fan_in, fan_out, int(skip)
        net.k_trunk[i], net.k_pad[i] = k_trunk, k_pad
        net.w[i], net.b[i] = w.data_ptr(), b.data_ptr()
    net.max_v = model.max
    for c in range(3):
        net.mean[c] = model.mean[c]
    return net


def equirect_from_dir(esc_dir: Vec3, azimuth: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Equirect (u, v); non-escaped lanes (zero directions) give (0, 0)."""
    escaped = esc_dir.norm2() > 0.5
    u, v = equirect_uv(esc_dir, azimuth)
    zero = torch.zeros_like(u)
    return torch.where(escaped, u, zero), torch.where(escaped, v, zero)


def nif_env_shade_plain(model: NifModel, esc_dir: Vec3, esc_w: Vec3, azimuth: float) -> Vec3:
    """Plain PyTorch version of the env-shade kernel -> RGB contribution."""
    if esc_dir.x.is_cuda:
        nif_env_shade_plain.cuda_runs += 1
    u, v = equirect_from_dir(esc_dir, azimuth)
    out = nif_apply(model, u, v)  # (P, 3) network (bgr) order
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
    dev = _lib.require_cuda("env shade", escd, escw, *model.kernels, *model.biases)
    n = escd.shape[1]
    net = net_struct(model)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    err = _lib.library().pt_env_shade(ctypes.byref(net), _lib.ptr(escd), _lib.ptr(escw),
                                      float(azimuth), n, _lib.ptr(out), _lib.stream(dev))
    _lib.check(err, "env shade")
    nif_env_shade.launches += 1
    return Vec3.unstack(out)


nif_env_shade.launches = 0
