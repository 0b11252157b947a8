"""K2 and K4: the NIF kernels - env shade of escaped rays, and the NIF at (u, v).

``nif_env_shade`` replaces ``ipu_path_trace_tpu/ops/nif_pallas.py::
nif_env_shade_pallas``: equirect (u, v) of each escape direction, the NIF
chain, the bgr -> rgb flip and the product with the escape weights, in
one kernel.  ``nif_apply_t`` replaces ``nif_apply_pallas_t``: the NIF at
given (u, v), (3, P) f32 in network channel order (``eval_env`` and the
baked env mode call it).  Both live in ``csrc/nif.cu`` and run the
``wgmma`` chains of ``csrc/nif_wgmma.cuh`` on the slices of
``wgmma_operands`` (``wg_struct``): a ``NifModel``'s bf16 chain, an f32
``NifModel``'s chain on TF32 ``wgmma`` (the reference's ``--partials-type
float``: 3xTF32 on the weights' hi and lo tf32 slices, 64-ray tiles), or a
``QuantNifModel``'s int8 chain (K5, ``_quant_mlp_core``: s8 slices under
the 64-byte swizzle, with its multipliers from ``wgmma_scales``).  K3
runs the same chains (ops/megastep.py), the probes K6 and K7
(probes/overlap.py) and K8 (probes/quant.py) too.
Each wrapper launches its kernel for CUDA tensors and runs its ``*_plain``
version for CPU tensors; a shape the ``wgmma`` chain cannot take raises
(``wgmma_plan``), and the launchers take a ``NifWg`` only (``wg_arg``).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.envmap import equirect_uv
from ..core.vecmath import Vec3
from ..models.nif import NifModel, nif_apply
from ..models.quant import QuantNifModel, nif_apply_quant
from . import _lib


def _cached(model: NifModel, attr: str, tensors, build):
    """``build()`` once per model, device and weight version."""
    key = (model.device, tuple((t.data_ptr(), t._version) for t in tensors))
    cached = getattr(model, attr, None)
    if cached is None or cached[0] != key:
        cached = (key, build())
        setattr(model, attr, cached)
    return cached[1]


# The wgmma chain's fixed shapes (csrc/nif_wgmma.cuh).
WG_RAYS = 128  # kWgRays: rays per tile of the bf16 and int8 chains
WG_TF32_RAYS = 64  # kWgTileRays<4>: the tf32 chain's tile
WG_ATOM = 64  # K values of a bf16 or s8 slice row and activation atom (tf32: 32)
WG_ATOM_BYTES = WG_RAYS * 2 * WG_ATOM  # kWgAtomBytes of the bf16 chain (128-byte rows)
WG_CHUNK = 64  # wgmma N of a hidden layer's output chunk
WG_MAX_CHUNKS = 6  # kWgMaxChunks: hidden widths up to 384
WG_REG_CHUNKS = 5  # kWgRegChunks: chunks a layer holds in registers at once
WG_PASS_CHUNKS = 3  # kWgPassChunks: chunks per pass of a wider layer
WG_HEAD_ROWS = 8  # wgmma N of the head: outputs padded to 8
WG_PASS_ROWS = 128  # kWgPassRows: outputs per pass of the 8-bit skip layer
WG_MAX_STAGES = 4  # kWgMaxStages
WG_SMEM_LIMIT = 232_448  # kWgSmemLimit: dynamic shared memory a block may use
WG_BAR_BYTES = 2 * WG_MAX_STAGES * 8  # full and empty mbarriers
WG_UV_BYTES = 2 * WG_RAYS * 4  # the tile's (u, v)
WG_ALIGN = 1024  # slack to align the dynamic shared memory to the swizzle's 1024 B


def row_bytes(elem: int) -> int:
    """Bytes of a K-major slice row (kWgRowBytes): 64 for s8 (the 64-byte
    swizzle), 128 for bf16 and f32 (the 128-byte swizzle)."""
    return 64 if elem == 1 else 128


def tile_rays(elem: int) -> int:
    """Rays of the chain's tile (kWgTileRays): 64 for the 4-byte tf32
    chain (its 128-ray activations and slices would not fit a block),
    else 128."""
    return WG_TF32_RAYS if elem == 4 else WG_RAYS


def chain_plan(layer_plan, feat: int, elem: int, tail_bytes: int = WG_UV_BYTES,
               what: str = "the wgmma chain") -> dict:
    """The ``wgmma`` chain's layers and shared-memory plan
    (csrc/nif_wgmma.cuh) for ``layer_plan`` [(fan_in, fan_out, skip)] over
    ``feat`` feature columns, in ``elem``-byte operands (2: bf16, 1: s8,
    4: f32 read as tf32): per layer its weight rows (a hidden layer's
    outputs rounded up to 64-wide chunks, the head's to 8), its trunk
    width, its K-slices of a row's K values (``row_bytes // elem``: 64, or
    32 for f32) from the activations (``in_atoms``) and from the features
    (``f_atoms``: layer 0 and the skip layer), its ``passes`` (the 8-bit
    skip layer's two dots run over WG_PASS_ROWS outputs at a time; a
    1- or 2-byte layer wider than WG_REG_CHUNKS chunks over WG_PASS_CHUNKS
    chunks at a time; each pass reading those rows of every slice) and the
    bytes of one fill of the ring (``fill_bytes``: a pass's rows of a
    slice); then the block's bytes - activation and feature atoms (a row
    for each of the tile's rays: ``tile_rays``), the codes an 8-bit layer
    in passes keeps back (``smem_codes``), ring stages of the
    largest fill (as many as fit, at most 4), barriers, ``tail_bytes``
    from ``smem_uv`` on (K2 and K4: the
    (u, v) of 128 rays; K3: ops/megastep.megastep_wg_plan), alignment -
    with each piece's offset.  Raises ValueError, naming the limit, for a
    shape the chain cannot take (``what`` names the kernel in the
    shared-memory message)."""
    if len(layer_plan) > _lib.NIF_MAX_LAYERS:
        raise ValueError(f"NIF has {len(layer_plan)} layers; the kernel takes at most "
                         f"{_lib.NIF_MAX_LAYERS}")
    row = row_bytes(elem)
    row_k = row // elem
    atom_bytes = tile_rays(elem) * row
    f_atoms = -(-feat // row_k)
    layers = []
    for i, (fan_in, fan_out, skip) in enumerate(layer_plan):
        if i == len(layer_plan) - 1:
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
        skip8 = elem == 1 and i and skip and chunks  # the 8-bit skip layer's two dots
        passes = (-(-chunks // 2) if skip8 else
                  -(-chunks // WG_PASS_CHUNKS) if elem != 4 and chunks > WG_REG_CHUNKS else 1)
        pass_rows = -(-chunks // passes) * WG_CHUNK if passes > 1 else rows
        layers.append(dict(fan_in=fan_in, fan_out=fan_out, trunk=trunk, rows=rows, chunks=chunks,
                           in_atoms=-(-trunk // row_k),
                           f_atoms=f_atoms if i == 0 or skip else 0,
                           passes=passes, slice_bytes=rows * row, fill_bytes=pass_rows * row))
    act_atoms = max([lay["chunks"] for lay in layers] + [0]) * WG_CHUNK // row_k
    stage_bytes = max(lay["fill_bytes"] for lay in layers)
    # The codes area of an 8-bit layer in passes: the skip layer's passes but
    # the last; every output of a layer wider than WG_REG_CHUNKS chunks
    # (wg_hidden_passes, and wg_skip's six chunks).
    codes = max([WG_RAYS * (lay["rows"] if lay["chunks"] > WG_REG_CHUNKS else
                            lay["fill_bytes"] // row * (lay["passes"] - 1))
                 for lay in layers if elem == 1 and lay["passes"] > 1] + [0])
    smem_feat = act_atoms * atom_bytes
    smem_codes = smem_feat + f_atoms * atom_bytes
    smem_ring = smem_codes + -(-codes // WG_ALIGN) * WG_ALIGN
    fixed = smem_ring + WG_BAR_BYTES + tail_bytes + WG_ALIGN
    stages = min(WG_MAX_STAGES, (WG_SMEM_LIMIT - fixed) // stage_bytes)
    if stages < 2:
        raise ValueError(f"{what} needs {fixed + 2 * stage_bytes} B of shared memory for two "
                         f"ring stages of {stage_bytes} B; a block has {WG_SMEM_LIMIT}")
    smem_bar = smem_ring + stages * stage_bytes
    smem_uv = smem_bar + WG_BAR_BYTES
    return dict(layers=layers, elem=elem, act_atoms=act_atoms, feat_atoms=f_atoms, stages=stages,
                stage_bytes=stage_bytes, smem_feat=smem_feat, smem_codes=smem_codes,
                smem_ring=smem_ring, smem_bar=smem_bar, smem_uv=smem_uv,
                smem_bytes=smem_uv + tail_bytes + WG_ALIGN)


def _elem(model: NifModel) -> int:
    """Operand bytes of the model's chain: 1 int8, 2 bf16, 4 f32 (tf32
    wgmma); other types raise."""
    if isinstance(model, QuantNifModel):
        return 1
    if model.dtype == torch.float32:
        return 4
    if model.dtype != torch.bfloat16:
        raise ValueError(f"the wgmma chains run bf16, f32 or int8 weights; model is "
                         f"{model.dtype}")
    return 2


def chain_name(model: NifModel) -> str:
    """The model's chain as the kernels' records name it: bf16, tf32 or int8."""
    return {1: "int8", 2: "bf16", 4: "tf32"}[_elem(model)]


def wgmma_plan(model: NifModel, tail_bytes: int = WG_UV_BYTES,
               what: str = "the wgmma chain") -> dict:
    """``chain_plan`` of the model: its layers, its 4E Fourier features,
    its chain's operand width (bf16, f32 or, for a QuantNifModel, int8)."""
    return chain_plan(model.layer_plan(), 4 * model.embedding_dim, _elem(model), tail_bytes, what)


def swizzle(x: torch.Tensor) -> torch.Tensor:
    """(rows, K * atoms) -> (atoms, rows, K): each K-column atom in the
    K-major swizzle image that ``wgmma`` reads - a row of K values is 128
    bytes of bf16 (K = 64) or f32 (K = 32) under the 128-byte swizzle
    (16-byte chunk c of row r at chunk c ^ (r % 8)) or 64 bytes of int8
    (K = 64, the 64-byte swizzle: chunk c at c ^ ((r // 2) % 4)).  The
    permutation is its own inverse within an atom."""
    size = x.element_size()
    row_k = row_bytes(size) // size
    rows, atoms = x.shape[0], x.shape[1] // row_k
    per = 16 // size  # values per 16-byte chunk
    n = row_k // per  # chunks per row: 8 or 4
    chunks = x.reshape(rows, atoms, n, per).permute(1, 0, 2, 3)
    r = torch.arange(rows, device=x.device)
    idx = torch.arange(n, device=x.device)[None, :] ^ ((r[:, None] // (8 // n)) % n)
    return torch.gather(chunks, 2, idx[None, :, :, None].expand(atoms, rows, n, per)).reshape(
        atoms, rows, row_k)


def chain_slices(lay: dict, wt: torch.Tensor) -> torch.Tensor:
    """One layer's (out, in) weights as ``chain_plan``'s K-slices, back to
    back in the order the kernel reads them - trunk inputs, then (layer 0
    and the skip layer) the feature inputs - each (rows, K) in the swizzle
    image of its type (K = 64; 32 for f32), zero past fan-in and fan-out.
    One slice is one bulk copy into the ring."""
    parts = []
    row_k = row_bytes(wt.element_size()) // wt.element_size()
    for lo, hi, atoms in ((0, lay["trunk"], lay["in_atoms"]),
                          (lay["trunk"], lay["fan_in"], lay["f_atoms"])):
        if atoms:
            x = wt.new_zeros((lay["rows"], atoms * row_k))
            x[:lay["fan_out"], :hi - lo] = wt[:, lo:hi]
            parts.append(swizzle(x))
    return torch.cat(parts).contiguous()


def pad_rows(v: torch.Tensor, rows: int) -> torch.Tensor:
    """An (out,) per-output vector as f32 (rows,), zeros past out."""
    out = torch.zeros(rows, dtype=torch.float32, device=v.device)
    out[:v.shape[0]] = v.reshape(-1).float()
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 value (10 mantissa bits), ties away from zero:
    the rounding of ``cvt.rna.tf32.f32`` (csrc/nif_wgmma.cuh tf32_round).
    Adding half a tf32 ulp to the bits rounds the magnitude; clearing the
    13 low bits truncates it.  For finite values."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo) = (tf32(x), tf32(x - hi)): the tf32 chain's 3xTF32
    split of an operand, which the kernel applies to A in registers and
    the host to the weights."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def wgmma_operands(model: NifModel) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The ``wgmma`` chain's operands (K2, K3, K4), per layer (slices, f32
    bias): ``chain_slices`` of the layer's (out, in) weights - bf16, the hi
    part of f32 weights (``tf32_split``; ``wgmma_lo_slices`` has the lo
    part), or a QuantNifModel's int8 codes - and the bias padded with
    zeros to the rows (f32: the epilogue adds it).  Cached on the model."""
    def build():
        def operand(w):
            return tf32_split(w)[0] if w.dtype == torch.float32 else w

        return [(chain_slices(lay, operand(w.t())), pad_rows(b, lay["rows"]))
                for lay, w, b in zip(wgmma_plan(model)["layers"], model.kernels, model.biases)]

    return _cached(model, "_wgmma_operands", model.kernels + model.biases, build)


def wgmma_lo_slices(model: NifModel) -> list[torch.Tensor | None]:
    """The tf32 chain's lo slices per layer: ``chain_slices`` of the lo part
    of the f32 weights (``tf32_split``), streamed after each hi slice; None
    for a layer whose weights are all tf32 values (every f16-trained asset's),
    whose lo part is zero.  Cached on the model."""
    def build():
        out = []
        for lay, w in zip(wgmma_plan(model)["layers"], model.kernels):
            lo = tf32_split(w.t())[1]
            out.append(chain_slices(lay, lo) if bool(lo.any()) else None)
        return out

    return _cached(model, "_wgmma_lo_slices", model.kernels, build)


def wgmma_scales(model: QuantNifModel) -> tuple[list[torch.Tensor], torch.Tensor, list]:
    """The int8 chain's multipliers as the kernel reads them: per layer the
    accumulator multipliers, and the skip layer's feature-dot ones, each
    padded with zeros to the layer's rows (a padded output computes 0);
    and the quant steps ``inv_next`` as host floats (read from the device
    once, not at every launch).  Cached on the model."""
    def build():
        layers = wgmma_plan(model)["layers"]
        skip = model.skip_layer
        return ([pad_rows(m, lay["rows"]) for lay, m in zip(layers, model.mults)],
                pad_rows(model.mult_skip,
                         layers[skip]["rows"] if skip >= 0 else model.mult_skip.shape[0]),
                model.inv_next.tolist())

    return _cached(model, "_wgmma_scales", model.mults + [model.mult_skip, model.inv_next],
                   build)


def wg_net(plan: dict, operands, embed_dim: int, log_flag: bool, max_v: float, mean,
           scales=None, lo_slices=None) -> _lib.NifWg:
    """A NifWg of ``plan`` over ``operands`` [(slices, bias)] - for the
    narrow chains (the 8-bit ones, ``plan["elem"] == 1``, and K8's fp8 on
    the bf16 tile) ``scales``: the per-layer multipliers, the skip
    multipliers and the per-layer quant steps; for the tf32 chain
    ``lo_slices`` (per layer the lo slices or None) - with the decode's
    constants.  The tensors must outlive the launches."""
    net = _lib.NifWg()
    net.num_layers = len(plan["layers"])
    net.embed_dim = embed_dim
    net.log_flag = int(log_flag)
    for key in ("stages", "stage_bytes", "feat_atoms", "smem_feat", "smem_ring", "smem_bar",
                "smem_uv", "smem_bytes", "smem_codes"):
        setattr(net, key, plan[key])
    for i, (lay, (w, b)) in enumerate(zip(plan["layers"], operands)):
        for key in ("chunks", "in_atoms", "f_atoms", "slice_bytes", "passes"):
            getattr(net, key)[i] = lay[key]
        net.w[i], net.b[i] = w.data_ptr(), b.data_ptr()
    net.max_v = max_v
    for c in range(3):
        net.mean[c] = mean[c]
    net.int8 = int(plan["elem"] == 1)
    net.tf32 = int(plan["elem"] == 4)
    for i, lo in enumerate(lo_slices or []):
        net.w_lo[i] = None if lo is None else lo.data_ptr()
    if scales is not None:
        mults, mult_skip, inv_next = scales
        for i, (m, inv) in enumerate(zip(mults, inv_next)):
            net.mult[i], net.inv_next[i] = m.data_ptr(), inv
        net.mult_skip = mult_skip.data_ptr()
    return net


def wg_struct(model: NifModel, plan: dict | None = None) -> _lib.NifWg:
    """The ``wgmma`` kernels' view of a bf16, f32 or int8 model: the plan
    (K2 and K4's ``wgmma_plan`` unless given; K3 passes its own) and
    pointers to the slices, biases and (int8) multipliers, kept alive by
    the model's cache."""
    elem = _elem(model)  # bf16, f32 or int8
    plan = plan or wgmma_plan(model)
    return wg_net(plan, wgmma_operands(model), model.embedding_dim, model.log_tone_map,
                  model.max, model.mean,
                  wgmma_scales(model) if elem == 1 else None,
                  wgmma_lo_slices(model) if elem == 4 else None)


def wg_arg(net) -> ctypes._CArgObject:
    """The ``wgmma`` kernels' chain argument (K2, K3, K4, K6, K7, K8): a
    NifWg (``wg_struct``); anything else raises."""
    if not isinstance(net, _lib.NifWg):
        raise ValueError(f"the NIF kernels take a NifWg (the wgmma chain), not a "
                         f"{type(net).__name__}")
    return ctypes.byref(net)


def model_tensors(model: NifModel) -> list[torch.Tensor]:
    extra = model.mults + [model.mult_skip] if isinstance(model, QuantNifModel) else []
    return model.kernels + model.biases + extra


def _chain_plain(model: NifModel, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(P, 3) decoded NIF output, network order: the int8 chain, or the
    model's bf16 or f32 chain."""
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
    with torch.cuda.device(dev):
        err = _lib.library().pt_nif_apply(wg_arg(wg_struct(model)), _lib.ptr(u), _lib.ptr(v), n,
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
    with torch.cuda.device(dev):
        err = _lib.library().pt_env_shade(wg_arg(wg_struct(model)), _lib.ptr(escd),
                                          _lib.ptr(escw), float(azimuth), n, _lib.ptr(out),
                                          _lib.stream(dev))
    _lib.check(err, "env shade")
    nif_env_shade.launches += 1
    return Vec3.unstack(out)


nif_env_shade.launches = 0
