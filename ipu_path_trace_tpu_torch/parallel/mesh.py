"""The render step sharded over a device mesh.

Counterpart of ``ipu_path_trace_tpu/parallel/mesh.py``.  A ``Mesh`` is a
(pixels, samples) grid of ``torch.device``s driven by one process, as the
reference's single controller drives its chips:

  * "pixels" axis: the worklist is split into contiguous slices; shard i
    traces slice i with its own replica of the scene and the env, so no
    ray data crosses devices;
  * "samples" axis: the replicas of a pixel shard render the same pixels
    with decorrelated streams; each replica's delta (r, g, b,
    sample_count, path_length, and the adaptive step's lum2) is summed over
    the axis and added to every replica's copy (the film reduction).

Each shard's launches are issued in turn and run asynchronously on their
own device: nothing in a shard's step reads back from the card, so every
shard is queued before the first sync of the step.

Seeds: shard (i, j) renders with ``fold_seed(fold_seed(seed, i), j)``.
The port's Philox streams cannot match ``jax.random`` (ROADMAP.md queue
3), so the fold is the port's own and only has to agree between the mesh
and its single-device replay.  Sobol: replica j draws each lane's sequence
at base + j x (its samples this step), so the replicas draw disjoint
slices; the caller advances the base by the whole axis' samples.

The reduction is chosen from the mesh's devices, never after an error:
with one replica per pixel shard there is nothing to reduce; replicas
that share one device (the virtual mesh of the tests and chip_smoke.py,
or the CPU) are summed on that device in replica order; replicas on
distinct GPUs are summed by NCCL (``torch.cuda.nccl.all_reduce``).  A
mesh whose replicas do neither is refused when it is made.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch

from ..core.records import WorkBatch
from ..core.scene import Scene
from ..models.envlight import NifEnv, TextureEnv
from ..models.nif import NifModel
from ..ops.megastep import BUDGET_BLOCK
from ..ops.trace import philox4x32_10
from ..render.params import RenderSettings, StaticConfig
from ..utils.tracing import span

# Counter word 1 of fold_seed's Philox draw ("mesh"): far from the sample
# indices the kernels put there under the same key.
FOLD_TAG = 0x6D657368
_MASK32 = 0xFFFFFFFF
_SUMMED = ("r", "g", "b", "sample_count", "path_length")


def fold_seed(seed: tuple[int, int], index: int) -> tuple[int, int]:
    """The two seed words ``seed`` folded with ``index``: the first two
    words of Philox4x32-10 keyed by the seed at counter (index, FOLD_TAG,
    0, 0).  Deterministic, and a different stream per index."""
    words = philox4x32_10([int(index) & _MASK32, FOLD_TAG, 0, 0],
                          int(seed[0]) & _MASK32, int(seed[1]) & _MASK32)
    return int(words[0]), int(words[1])


def shard_seed(seed: tuple[int, int], i: int, j: int) -> tuple[int, int]:
    """The seed words of shard (i, j): folded with the pixel index, then
    with the sample index."""
    return fold_seed(fold_seed(seed, i), j)


def parse_mesh_shape(mesh_shape: str, num_devices: int) -> tuple[int, int]:
    """'4x2' -> (4, 2); '' -> (num_devices, 1)."""
    if not mesh_shape:
        return (num_devices, 1)
    parts = mesh_shape.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"mesh-shape must be 'PIXELSxSAMPLES', got '{mesh_shape}'")
    px, sm = int(parts[0]), int(parts[1])
    if px * sm != num_devices:
        raise ValueError(
            f"mesh-shape {px}x{sm} needs {px * sm} devices but {num_devices} requested")
    return (px, sm)


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A (pixels, samples) grid of devices; ``devices[i][j]`` runs shard
    (i, j).  ``reduction`` is how a pixel shard's replicas are summed:
    "none" (one replica), "sum" (all on one device) or "nccl" (each on
    its own GPU)."""

    def __init__(self, devices):
        rows = tuple(tuple(_canonical(d) for d in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        self.devices = rows
        self.shape = {"pixels": len(rows), "samples": len(rows[0])}
        self.reduction = self._reduction()

    def _reduction(self) -> str:
        if self.shape["samples"] == 1:
            return "none"
        kinds = set()
        for row in self.devices:
            if len(set(row)) == 1:
                kinds.add("sum")
            elif len(set(row)) == len(row) and all(d.type == "cuda" for d in row):
                kinds.add("nccl")
            else:
                raise ValueError(f"the sample replicas {[str(d) for d in row]} neither share "
                                 "one device nor sit on distinct GPUs")
        if len(kinds) > 1:
            raise ValueError("the pixel shards' replicas mix one device and distinct GPUs")
        return kinds.pop()

    @property
    def size(self) -> int:
        return self.shape["pixels"] * self.shape["samples"]

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]

    def distinct(self) -> list[torch.device]:
        """The mesh's devices, each once, in shard order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def synchronize(self) -> None:
        for k, d in enumerate(self.distinct()):
            if d.type == "cuda":
                with span(f"card_sync/{k}"):
                    torch.cuda.synchronize(d)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape['pixels']}x{self.shape['samples']}, "
                f"{[str(d) for d in self.distinct()]}, reduction={self.reduction})")


def make_mesh(num_devices: int | None = None, mesh_shape: str = "", devices=None) -> Mesh:
    """A mesh over the first ``num_devices`` of ``devices`` (default: every
    CUDA device), shaped by ``mesh_shape`` ('' = all on the pixel axis).
    An explicit ``devices`` list may repeat a device: a virtual mesh."""
    if devices is None:
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
        what = "GPUs"
    else:
        devices = [torch.device(d) for d in devices]
        what = "devices"
    n = num_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"Requested {n} {what} but only {len(devices)} available.")
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    px, sm = parse_mesh_shape(mesh_shape, n)
    return Mesh([devices[i * sm:(i + 1) * sm] for i in range(px)])


# --- replicated and sharded values ------------------------------------------------------------

class Replicated:
    """One copy of a value per distinct device of a mesh (``on``)."""

    def __init__(self, copies: dict):
        self.copies = copies

    def on(self, device) -> object:
        return self.copies[_canonical(device)]


def model_to(model: NifModel, device) -> NifModel:
    """``model`` on ``device``: itself when it is there, else a copy (so
    ops/nif.py builds the copy's ``wgmma`` operands on its own device)."""
    if model.device == _canonical(device):
        return model
    return copy.deepcopy(model).to(device)


def _copy_to(value, device):
    if isinstance(value, Scene):
        return value.to(device)
    if isinstance(value, NifEnv):
        model = model_to(value.model, device)
        return value if model is value.model else NifEnv(model=model)
    if isinstance(value, TextureEnv):
        return value._replace(texture=value.texture.to(device))
    return value  # plain values: a ConstantEnv, RenderSettings


def replicate(value, mesh: Mesh) -> Replicated:
    """A scene, an env or settings copied onto each device of the mesh
    (once per distinct device)."""
    if isinstance(value, Replicated):
        return value
    return Replicated({d: _copy_to(value, d) for d in mesh.distinct()})


def _on(value, device):
    return value.on(device) if isinstance(value, Replicated) else value


class Sharded(NamedTuple):
    """A worklist or a per-record array split along the pixel axis:
    ``parts[i][j]`` is pixel shard i's copy on device (i, j) (replicas on
    one device share it)."""

    mesh: Mesh
    parts: tuple


def _split(x, mesh: Mesh, n: int):
    px = mesh.shape["pixels"]
    if n % px:
        raise ValueError(f"Worklist size {n} not divisible by pixel-axis size {px}.")
    per = n // px
    parts = []
    for i, row in enumerate(mesh.devices):
        copies = {}
        for dev in row:
            if dev not in copies:
                if isinstance(x, WorkBatch):
                    copies[dev] = WorkBatch(*(t[i * per:(i + 1) * per].to(dev) for t in x))
                else:
                    copies[dev] = x[i * per:(i + 1) * per].to(dev)
        parts.append(tuple(copies[dev] for dev in row))
    return Sharded(mesh, tuple(parts))


def shard_work(work: WorkBatch, mesh: Mesh) -> Sharded:
    """The worklist split along the pixel axis onto the mesh's devices;
    its size must divide by the axis."""
    return _split(work, mesh, int(work.u.shape[0]))


def shard_array(x: torch.Tensor, mesh: Mesh) -> Sharded:
    """A per-record array (the adaptive lum2) split like the worklist."""
    return _split(x, mesh, int(x.shape[0]))


def gather_work(sharded: Sharded, device=None):
    """The whole worklist (or array) on ``device`` (default: the mesh's
    first device): replica 0 of each pixel shard, in shard order."""
    device = sharded.mesh.first if device is None else torch.device(device)
    first = [row[0] for row in sharded.parts]
    if isinstance(first[0], WorkBatch):
        return WorkBatch(*(torch.cat([getattr(p, f).to(device) for p in first])
                           for f in WorkBatch._fields))
    return torch.cat([p.to(device) for p in first])


# --- the sharded steps -----------------------------------------------------------------------

def _sum_replicas(mesh: Mesh, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each replica's total of ``tensors`` (one per replica of a pixel
    shard), by the mesh's reduction."""
    if mesh.reduction == "nccl":
        from torch.cuda import nccl

        bufs = [t.contiguous() for t in tensors]
        nccl.all_reduce(bufs)
        return bufs
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t
    return [total] * len(tensors)


def _film_reduction(mesh: Mesh, ins: list, outs: list, lum2_in=None, lum2_out=None):
    """A pixel shard's replicas after the step: each input plus the sum of
    every replica's delta.  With one replica its output as it is."""
    if len(outs) == 1:
        return (tuple(outs), None if lum2_out is None else tuple(lum2_out))
    with span("film_reduction"):
        totals = {f: _sum_replicas(mesh, [getattr(o, f) - getattr(w, f)
                                          for o, w in zip(outs, ins)])
                  for f in _SUMMED}
        new = tuple(w._replace(**{f: getattr(w, f) + totals[f][k] for f in _SUMMED})
                    for k, w in enumerate(ins))
        if lum2_out is None:
            return new, None
        dl = _sum_replicas(mesh, [o - w for o, w in zip(lum2_out, lum2_in)])
        return new, tuple(w + dl[k] for k, w in enumerate(lum2_in))


def _as_sharded(work, mesh: Mesh) -> Sharded:
    return work if isinstance(work, Sharded) else shard_work(work, mesh)


def sharded_render_step(scene, settings: RenderSettings, cfg: StaticConfig, work, seed,
                        env, mesh: Mesh, *, noise=None, sobol_base=None) -> Sharded:
    """One render step sharded over the mesh (render/wavefront.render_step
    per shard).

    ``settings.samples_per_step`` is each replica's sample count: the
    step adds samples_per_step x mesh.shape['samples'] samples per pixel.
    ``work`` is a ``Sharded`` worklist (or a WorkBatch, sharded here);
    ``scene`` and ``env`` are ``Replicated`` (or values already on every
    shard's device).  Hardware mode folds ``seed`` per shard
    (``shard_seed``); host-noise mode takes ``noise[i][j]`` for shard
    (i, j), with ``seed`` None.  ``sobol_base`` is render_step's.
    """
    from ..render.wavefront import render_step

    work = _as_sharded(work, mesh)
    outs = []
    for i, row in enumerate(mesh.devices):
        with span(f"shard_launch/{i}"):
            outs.append([
                render_step(_on(scene, dev), settings, cfg, work.parts[i][j],
                            None if seed is None else shard_seed(seed, i, j), _on(env, dev),
                            noise=None if noise is None else noise[i][j],
                            sobol_base=sobol_base, sample_axis_index=j)
                for j, dev in enumerate(row)])
    return Sharded(mesh, tuple(_film_reduction(mesh, list(work.parts[i]), outs[i])[0]
                               for i in range(len(outs))))


def sharded_adaptive_render_step(scene, settings: RenderSettings, cfg: StaticConfig, work, lum2,
                                 seed, env, mesh: Mesh, *, noise=None,
                                 block_size: int = BUDGET_BLOCK) -> tuple[Sharded, Sharded]:
    """The adaptive step (render/adaptive.py) sharded over the mesh.

    Each pixel shard runs its own controller on its local moments: the
    budgets need no collective, and every shard targets the same per-step
    total.  The sample replicas hold the same summed moments, so they
    compute the same budgets, and their contributions (lum2 included) are
    reduced as the uniform step's.  ``lum2`` is a ``Sharded`` array (or a
    tensor, sharded here).
    """
    from ..render.adaptive import adaptive_render_step

    work = _as_sharded(work, mesh)
    lum2 = lum2 if isinstance(lum2, Sharded) else shard_array(lum2, mesh)
    parts, l2_parts = [], []
    for i, row in enumerate(mesh.devices):
        with span(f"shard_launch/{i}"):
            res = [adaptive_render_step(_on(scene, dev), settings, cfg, work.parts[i][j],
                                        lum2.parts[i][j],
                                        None if seed is None else shard_seed(seed, i, j),
                                        _on(env, dev),
                                        noise=None if noise is None else noise[i][j],
                                        block_size=block_size, sample_axis_index=j)
                   for j, dev in enumerate(row)]
        new, l2 = _film_reduction(mesh, list(work.parts[i]), [r[0] for r in res],
                                  list(lum2.parts[i]), [r[1] for r in res])
        parts.append(new)
        l2_parts.append(l2)
    return Sharded(mesh, tuple(parts)), Sharded(mesh, tuple(l2_parts))


def make_step_fn(cfg: StaticConfig, mesh: Mesh | None = None):
    """The render-step callable for a config and an optional mesh:
    fn(scene, settings, work, seed, env, **kw) -> the stepped worklist."""
    from ..render.wavefront import render_step

    if mesh is None:
        return lambda scene, settings, work, seed, env, **kw: render_step(
            scene, settings, cfg, work, seed, env, **kw)
    return lambda scene, settings, work, seed, env, **kw: sharded_render_step(
        scene, settings, cfg, work, seed, env, mesh, **kw)


def make_adaptive_step_fn(cfg: StaticConfig, mesh: Mesh | None = None):
    """make_step_fn's analog for the adaptive step:
    fn(scene, settings, work, lum2, seed, env, **kw) -> (work, lum2)."""
    from ..render.adaptive import adaptive_render_step

    if mesh is None:
        return lambda scene, settings, work, lum2, seed, env, **kw: adaptive_render_step(
            scene, settings, cfg, work, lum2, seed, env, **kw)
    return lambda scene, settings, work, lum2, seed, env, **kw: sharded_adaptive_render_step(
        scene, settings, cfg, work, lum2, seed, env, mesh, **kw)
