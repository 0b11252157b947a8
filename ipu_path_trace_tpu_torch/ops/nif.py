"""K2 and K4: the NIF kernels - env shade of escaped rays, and the NIF at (u, v).

``nif_env_shade`` replaces ``ipu_path_trace_tpu/ops/nif_pallas.py::
nif_env_shade_pallas``: equirect (u, v) of each escape direction, the NIF
chain, the bgr -> rgb flip and the product with the escape weights, in
one kernel.  ``nif_apply_t`` replaces ``nif_apply_pallas_t``: the NIF at
given (u, v), (3, P) f32 in network channel order (``eval_env`` and the
baked env mode call it).  Both live in ``csrc/nif.cu``.  For a
``NifModel`` (bf16) they run the ``wgmma`` chain of
``csrc/nif_wgmma.cuh`` on the slices of ``wgmma_operands`` (``wg_struct``);
for a ``QuantNifModel`` the int8 chain (K5, ``_quant_mlp_core``) of
``csrc/nif_dev.cuh`` (``net_struct``).  The bf16 ``mma.sync`` chain of
``nif_dev.cuh`` (``kernel_operands``) serves the probes K6 and K8; K3
runs the ``wgmma`` chain too (ops/megastep.py).
Each wrapper launches its kernel for CUDA tensors and runs its ``*_plain``
version for CPU tensors; a bf16 shape the ``wgmma`` chain cannot take
raises (``wgmma_plan``).
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
    """bf16 ``mma.sync`` chain (K6, K8), per layer (packed weights, f32
    bias, k_trunk, k_pad): bf16 rows with K padded to 16 - the B-fragment
    layout of csrc/nif_dev.cuh::nif_layers.  Cached on the model."""
    def build():
        return [(packed, b.float().contiguous(), k_trunk, k_pad) for (packed, k_trunk, k_pad), b
                in zip(_pack(model, torch.bfloat16, 16), model.biases)]

    return _cached(model, "_kernel_operands", model.kernels, build)


# The wgmma chain's fixed shapes (csrc/nif_wgmma.cuh).
WG_RAYS = 128  # kWgRays: rays per tile
WG_ATOM = 64  # K values of a slice and of an activation atom: one 128-byte row
WG_ATOM_BYTES = WG_RAYS * 2 * WG_ATOM  # kWgAtomBytes
WG_CHUNK = 64  # wgmma N of a hidden layer's output chunk
WG_MAX_CHUNKS = 5  # kWgMaxChunks: hidden widths up to 320
WG_HEAD_ROWS = 8  # wgmma N of the head: 3 outputs padded to 8
WG_MAX_STAGES = 4  # kWgMaxStages
WG_SMEM_LIMIT = 232_448  # kWgSmemLimit: dynamic shared memory a block may use
WG_BAR_BYTES = 2 * WG_MAX_STAGES * 8  # full and empty mbarriers
WG_UV_BYTES = 2 * WG_RAYS * 4  # the tile's (u, v)
WG_ALIGN = 1024  # slack to align the dynamic shared memory to the swizzle's 1024 B


def wgmma_plan(model: NifModel, tail_bytes: int = WG_UV_BYTES,
               what: str = "the wgmma chain") -> dict:
    """The ``wgmma`` chain's layers and shared-memory plan
    (csrc/nif_wgmma.cuh): per layer its weight rows (a hidden layer's
    outputs rounded up to 64-wide chunks, the head's to 8), its trunk
    width and its 64-input K-slices from the activations (``in_atoms``)
    and from the Fourier features (``f_atoms``: layer 0 and the skip
    layer); then the block's bytes - activation and feature atoms, ring
    stages of the largest slice (as many as fit, at most 4), barriers,
    ``tail_bytes`` from ``smem_uv`` on (K2 and K4: the tile's (u, v); K3:
    ops/megastep.megastep_wg_plan), alignment - with each piece's offset.
    Raises ValueError, naming the limit, for a shape the chain cannot take
    (``what`` names the kernel in the shared-memory message)."""
    plan = model.layer_plan()
    if len(plan) > _lib.NIF_MAX_LAYERS:
        raise ValueError(f"NIF has {len(plan)} layers; the kernel takes at most "
                         f"{_lib.NIF_MAX_LAYERS}")
    feat = 4 * model.embedding_dim
    f_atoms = -(-feat // WG_ATOM)
    layers = []
    for i, (fan_in, fan_out, skip) in enumerate(plan):
        if i == len(plan) - 1:
            if fan_out > WG_HEAD_ROWS:
                raise ValueError(f"NIF head has {fan_out} outputs; the wgmma chain's head "
                                 f"takes at most {WG_HEAD_ROWS}")
            rows, chunks = WG_HEAD_ROWS, 0
        else:
            chunks = -(-fan_out // WG_CHUNK)
            if chunks > WG_MAX_CHUNKS:
                raise ValueError(f"NIF layer {i} has {fan_out} outputs; the wgmma chain takes "
                                 f"hidden widths up to {WG_MAX_CHUNKS * WG_CHUNK}")
            rows = chunks * WG_CHUNK
        trunk = 0 if i == 0 else fan_in - feat if skip else fan_in
        layers.append(dict(fan_in=fan_in, fan_out=fan_out, trunk=trunk, rows=rows, chunks=chunks,
                           in_atoms=-(-trunk // WG_ATOM),
                           f_atoms=f_atoms if i == 0 or skip else 0,
                           slice_bytes=rows * 2 * WG_ATOM))
    act_atoms = max([lay["chunks"] for lay in layers] + [0])
    stage_bytes = max(lay["slice_bytes"] for lay in layers)
    smem_feat = act_atoms * WG_ATOM_BYTES
    smem_ring = smem_feat + f_atoms * WG_ATOM_BYTES
    fixed = smem_ring + WG_BAR_BYTES + tail_bytes + WG_ALIGN
    stages = min(WG_MAX_STAGES, (WG_SMEM_LIMIT - fixed) // stage_bytes)
    if stages < 2:
        raise ValueError(f"{what} needs {fixed + 2 * stage_bytes} B of shared memory for two "
                         f"ring stages of {stage_bytes} B; a block has {WG_SMEM_LIMIT}")
    smem_bar = smem_ring + stages * stage_bytes
    smem_uv = smem_bar + WG_BAR_BYTES
    return dict(layers=layers, act_atoms=act_atoms, feat_atoms=f_atoms, stages=stages,
                stage_bytes=stage_bytes, smem_feat=smem_feat, smem_ring=smem_ring,
                smem_bar=smem_bar, smem_uv=smem_uv,
                smem_bytes=smem_uv + tail_bytes + WG_ALIGN)


def swizzle128(x: torch.Tensor) -> torch.Tensor:
    """(rows, 64 * atoms) -> (atoms, rows, 64): each 64-column atom in the
    K-major 128-byte-swizzle image that ``wgmma`` reads, 8-element (16-byte)
    chunk c of row r at chunk c ^ (r % 8).  The permutation is its own
    inverse within an atom."""
    rows, atoms = x.shape[0], x.shape[1] // WG_ATOM
    chunks = x.reshape(rows, atoms, 8, 8).permute(1, 0, 2, 3)
    r = torch.arange(rows, device=x.device)
    idx = torch.arange(8, device=x.device)[None, :] ^ (r[:, None] % 8)
    return torch.gather(chunks, 2, idx[None, :, :, None].expand(atoms, rows, 8, 8)).reshape(
        atoms, rows, WG_ATOM)


def wgmma_operands(model: NifModel) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """bf16 ``wgmma`` chain (K2, K3, K4), per layer (slices, f32 bias): the
    layer's (out, in) weights as ``wgmma_plan``'s K-slices, back to back in
    the order the kernel reads them - trunk inputs, then (layer 0 and the
    skip layer) the Fourier-feature inputs - each (rows, 64) in the
    128-byte-swizzle image, zero past fan-in and fan-out; the bias padded
    with zeros to the rows.  One slice is one bulk copy into the ring.
    Cached on the model."""
    def build():
        out = []
        for lay, w, b in zip(wgmma_plan(model)["layers"], model.kernels, model.biases):
            wt = w.t()
            parts = []
            for lo, hi, atoms in ((0, lay["trunk"], lay["in_atoms"]),
                                  (lay["trunk"], lay["fan_in"], lay["f_atoms"])):
                if atoms:
                    x = wt.new_zeros((lay["rows"], atoms * WG_ATOM))
                    x[:lay["fan_out"], :hi - lo] = wt[:, lo:hi]
                    parts.append(swizzle128(x))
            bias = torch.zeros(lay["rows"], dtype=torch.float32, device=b.device)
            bias[:lay["fan_out"]] = b.float()
            out.append((torch.cat(parts).contiguous(), bias))
        return out

    return _cached(model, "_wgmma_operands", model.kernels + model.biases, build)


def wg_struct(model: NifModel, plan: dict | None = None) -> _lib.NifWg:
    """The ``wgmma`` kernels' view of a bf16 model: the plan (K2 and K4's
    ``wgmma_plan`` unless given; K3 passes its own) and pointers to the
    slices and biases (kept alive by the model's cache)."""
    if model.dtype != torch.bfloat16:
        raise ValueError(f"the wgmma chain runs bf16 weights; model is {model.dtype}")
    plan = plan or wgmma_plan(model)
    net = _lib.NifWg()
    net.num_layers = len(plan["layers"])
    net.embed_dim = model.embedding_dim
    net.log_flag = int(model.log_tone_map)
    for key in ("stages", "stage_bytes", "feat_atoms", "smem_feat", "smem_ring", "smem_bar",
                "smem_uv", "smem_bytes"):
        setattr(net, key, plan[key])
    for i, (lay, (w, b)) in enumerate(zip(plan["layers"], wgmma_operands(model))):
        for key in ("chunks", "in_atoms", "f_atoms", "slice_bytes"):
            getattr(net, key)[i] = lay[key]
        net.w[i], net.b[i] = w.data_ptr(), b.data_ptr()
    net.max_v = model.max
    for c in range(3):
        net.mean[c] = model.mean[c]
    return net


def _kernel_nets(model: NifModel) -> tuple:
    """(NifNet, NifWg) arguments of K2 and K4: an int8 model's NifNet or a
    bf16 model's NifWg, the other None."""
    if isinstance(model, QuantNifModel):
        return ctypes.byref(net_struct(model)), None
    return None, ctypes.byref(wg_struct(model))


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
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    err = _lib.library().pt_nif_apply(*_kernel_nets(model), _lib.ptr(u), _lib.ptr(v), n,
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
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    err = _lib.library().pt_env_shade(*_kernel_nets(model), _lib.ptr(escd), _lib.ptr(escw),
                                      float(azimuth), n, _lib.ptr(out), _lib.stream(dev))
    _lib.check(err, "env shade")
    nif_env_shade.launches += 1
    return Vec3.unstack(out)


nif_env_shade.launches = 0
