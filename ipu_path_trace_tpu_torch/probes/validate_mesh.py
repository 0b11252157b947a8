"""The sharded render step against its single-device replay.

    python3 -m ipu_path_trace_tpu_torch.probes.validate_mesh          # one CUDA GPU
    python3 -m ipu_path_trace_tpu_torch.probes.validate_mesh --device cpu --size 64x48

Counterpart of ``scripts/validate_mesh_tpu.py``.  On a 1x1 mesh
(``run_1x1``) the sharded step (parallel/mesh.py) must equal the
mesh-less ``render_step`` rendered with the shard's folded seed
(``shard_seed(seed, 0, 0)``) bit for bit: Philox, then Sobol, then two
adaptive steps (lum2 included, with budgets that vary across blocks).

On virtual meshes whose shards all sit on one device (``run_virtual``:
8x1, 4x2 and 2x4 by default) the sharded step, fused (K3) and unfused
(K1 + K2), is held to ``replay``: each pixel slice rendered shard by shard
with the folded seeds on one device, the replicas' deltas summed in
replica order.  Bit for bit with one replica per pixel shard; within rtol
1e-6, atol 1e-7 with more (the reference's bound for its psum).  On CUDA
one sharded step also runs under ``torch.cuda.set_sync_debug_mode
("error")``: no shard's launch may wait on the host.  With ``--devices
cuda:0,cuda:1`` the same checks run on 2x1 and 1x2 meshes over those
GPUs (the replicas reduced by NCCL), against the replay on the first.

The NIF is the canonical asset, in bf16 and as its int8 twin (its QAT
grids).  Prints one line per check, the card's name and power limit,
and a JSON line; exits 1 on a failed check.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..core.records import WorkBatch, to_device_batch
from ..ops.megastep import BUDGET_BLOCK
from ..parallel.mesh import (gather_work, make_mesh, parse_mesh_shape, replicate, shard_array,
                             shard_seed, shard_work, sharded_adaptive_render_step,
                             sharded_render_step)

ROOT = Path(__file__).resolve().parents[2]
ASSET = ROOT / "assets" / "urban_alley_synth_nif"
INT8_ASSET = ROOT / "assets" / "urban_alley_synth_nif_int8"
WIDTH, HEIGHT, SPP = 1104, 1000, 8
SEED = (17, 18)
SHAPES = ("8x1", "4x2", "2x4")
RTOL, ATOL = 1e-6, 1e-7  # more than one sample replica (tests/test_mesh.py)
ADAPTIVE_MIN, ADAPTIVE_MAX_FACTOR = 2, 4.0


def worklist(width: int, height: int, scene, multiple_of: int = 1) -> np.ndarray:
    """The main path's worklist: padded, coherent order dealt over the shards."""
    from ..runtime.worklist import coherent_order, create_tracing_jobs

    return coherent_order(create_tracing_jobs(width, height, multiple_of=multiple_of), scene,
                          width, height, 90.0, shards=multiple_of)


def replay(scene, settings, cfg, work: WorkBatch, seed, env, shape: tuple[int, int], *,
           adaptive_lum2=None, block_size: int = BUDGET_BLOCK):
    """The sharded step of a (px, sm) mesh on one device: pixel slice i
    rendered once per replica j with ``shard_seed(seed, i, j)``, the
    replicas' deltas summed in replica order and added to the slice.
    With ``adaptive_lum2`` the adaptive step (budget blocks of
    ``block_size``), returning (work, lum2)."""
    from ..render.adaptive import adaptive_render_step
    from ..render.wavefront import render_step

    px, sm = shape
    n = work.u.shape[0]
    per = n // px
    parts, l2_parts = [], []
    for i in range(px):
        sl = WorkBatch(*(t[i * per:(i + 1) * per] for t in work))
        l2 = None if adaptive_lum2 is None else adaptive_lum2[i * per:(i + 1) * per]
        outs = []
        for j in range(sm):
            s = shard_seed(seed, i, j)
            if l2 is None:
                outs.append((render_step(scene, settings, cfg, sl, s, env, sample_axis_index=j),
                             None))
            else:
                outs.append(adaptive_render_step(scene, settings, cfg, sl, l2, s, env,
                                                 block_size=block_size, sample_axis_index=j))
        if sm == 1:
            parts.append(outs[0][0])
            l2_parts.append(outs[0][1])
            continue
        acc = {f: None for f in ("r", "g", "b", "sample_count", "path_length")}
        for o, _ in outs:
            for f in acc:
                d = getattr(o, f) - getattr(sl, f)
                acc[f] = d if acc[f] is None else acc[f] + d
        parts.append(sl._replace(**{f: getattr(sl, f) + acc[f] for f in acc}))
        if l2 is not None:
            dl = None
            for _, o2 in outs:
                dl = o2 - l2 if dl is None else dl + (o2 - l2)
            l2_parts.append(l2 + dl)
    whole = WorkBatch(*(torch.cat([getattr(p, f) for p in parts]) for f in WorkBatch._fields))
    if adaptive_lum2 is None:
        return whole
    return whole, torch.cat(l2_parts)


def compare(name: str, got, ref, exact: bool) -> dict:
    """Every field of two worklists (or two arrays): equal, or within
    RTOL/ATOL."""
    pairs = (zip(WorkBatch._fields, got, ref) if isinstance(got, WorkBatch)
             else [("lum2", got, ref)])
    ok, worst, fields = True, 0.0, {}
    for f, a, b in pairs:
        a, b = a.cpu(), b.cpu()
        eq = torch.equal(a, b)
        if not eq and not exact and a.dtype.is_floating_point:
            eq = bool(torch.allclose(a, b, rtol=RTOL, atol=ATOL))
        err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        ok, worst = ok and eq, max(worst, err)
        fields[f] = "equal" if torch.equal(a, b) else f"max|d|={err:.3e}"
    return {"name": name, "ok": ok, "exact": exact, "max_abs_err": worst, "fields": fields}


def load_envs(device, int8: bool = True) -> dict:
    """The canonical NIF env in bf16 and (``int8``) its int8 twin."""
    from ..runtime.app import parse_env_assets

    envs = {"bf16": parse_env_assets(str(ASSET), device)[0]}
    if int8:
        envs["int8"] = parse_env_assets(str(INT8_ASSET), device, "int8")[0]
    return envs


def run_1x1(device, width: int = WIDTH, height: int = HEIGHT, spp: int = SPP,
            envs: dict | None = None) -> list[dict]:
    """A 1x1 mesh on ``device`` against the mesh-less render with the
    folded seed, bit for bit: Philox, Sobol and two adaptive steps."""
    from ..core.scene import default_scene
    from ..render.adaptive import adaptive_render_step, compute_budgets
    from ..render.params import RenderSettings, StaticConfig
    from ..render.wavefront import render_step

    device = torch.device(device)
    scene = default_scene(device)
    envs = load_envs(device) if envs is None else envs
    mesh = make_mesh(1, "1x1", [device])
    work = to_device_batch(worklist(width, height, scene), device)
    settings = RenderSettings.make(samples_per_step=spp)
    s00 = shard_seed(SEED, 0, 0)
    out = []
    for chain, env in envs.items():
        scene_r, env_r = replicate(scene, mesh), replicate(env, mesh)
        for sampler in ("prng", "sobol"):
            cfg = StaticConfig(width=width, height=height, sampler=sampler)
            got = gather_work(sharded_render_step(scene_r, settings, cfg, shard_work(work, mesh),
                                                  SEED, env_r, mesh))
            ref = render_step(scene, settings, cfg, work, s00, env)
            out.append(compare(f"1x1 {chain} {sampler} {width}x{height} @ {spp} spp = mesh-less",
                               got, ref, exact=True))
        cfg = StaticConfig(width=width, height=height, adaptive_min=ADAPTIVE_MIN,
                           adaptive_max_factor=ADAPTIVE_MAX_FACTOR)
        lum2 = torch.zeros(work.u.shape[0], dtype=torch.float32, device=device)
        w_mesh, l_mesh = shard_work(work, mesh), shard_array(lum2, mesh)
        w_ref, l_ref = work, lum2
        for step in (1, 2):
            seed = (SEED[0] + step, SEED[1])
            w_mesh, l_mesh = sharded_adaptive_render_step(scene_r, settings, cfg, w_mesh, l_mesh,
                                                          seed, env_r, mesh)
            w_ref, l_ref = adaptive_render_step(scene, settings, cfg, w_ref, l_ref,
                                                shard_seed(seed, 0, 0), env)
        got = gather_work(w_mesh)
        row = compare(f"1x1 {chain} adaptive 2 steps {width}x{height} = mesh-less", got, w_ref,
                      exact=True)
        lum = compare("lum2", gather_work(l_mesh), l_ref, exact=True)
        counts = got.sample_count[got.u != 0xFFFF]
        row["budgets_vary"] = bool(counts.min() != counts.max())
        # The controller on the device against the same moments on the host.
        kw = dict(block_size=BUDGET_BLOCK, samples_per_step=spp, min_spp=ADAPTIVE_MIN,
                  max_spp=max(int(round(ADAPTIVE_MAX_FACTOR * spp)), spp))
        moments = (w_ref.r, w_ref.g, w_ref.b, l_ref, w_ref.sample_count)
        row["budgets_equal_host"] = torch.equal(
            compute_budgets(*moments, **kw).cpu(),
            compute_budgets(*(t.cpu() for t in moments), **kw))
        row["ok"] = (row["ok"] and lum["ok"] and row["budgets_vary"]
                     and row["budgets_equal_host"])
        row["fields"]["lum2"] = lum["fields"]["lum2"]
        out.append(row)
    return out


def run_virtual(device, shapes=SHAPES, width: int = WIDTH, height: int = HEIGHT,
                spp: int = SPP, env=None, devices=None) -> list[dict]:
    """Virtual meshes with every shard on ``device`` (or meshes over
    ``devices``, one shard each) against ``replay`` on ``device``, fused
    and unfused, ``spp`` samples a step split over the sample axis; on
    CUDA one more sharded step under set_sync_debug_mode("error"), and
    one adaptive step (the budgets computed on the device)."""
    from ..core.scene import default_scene
    from ..render.params import RenderSettings, StaticConfig

    device = torch.device(device)
    scene = default_scene(device)
    env = load_envs(device, int8=False)["bf16"] if env is None else env
    out = []
    for shape in shapes:
        n = int(np.prod([int(x) for x in shape.split("x")]))
        px, sm = parse_mesh_shape(shape, n)
        mesh = make_mesh(n, shape, [device] * n if devices is None else devices)
        kind = "virtual" if devices is None else f"{mesh.reduction} over {len(devices)} GPUs"
        work = to_device_batch(worklist(width, height, scene, px), device)
        settings = RenderSettings.make(samples_per_step=spp // sm)
        scene_r, env_r = replicate(scene, mesh), replicate(env, mesh)
        for fused in (True, False):
            cfg = StaticConfig(width=width, height=height, use_fused_step=fused)
            sharded = shard_work(work, mesh)
            got = gather_work(sharded_render_step(scene_r, settings, cfg, sharded, SEED, env_r,
                                                  mesh))
            ref = replay(scene, settings, cfg, work, SEED, env, (px, sm))
            out.append(compare(f"{kind} {shape} {'fused K3' if fused else 'unfused K1+K2'} "
                               f"{width}x{height} @ {spp} spp = replay", got, ref,
                               exact=sm == 1))
            if device.type == "cuda":
                out.append(no_sync_step(f"{kind} {shape} {'fused' if fused else 'unfused'} "
                                        "step under sync debug 'error'",
                                        lambda: sharded_render_step(
                                            scene_r, settings, cfg, sharded, SEED, env_r, mesh)))
        if device.type == "cuda":
            acfg = StaticConfig(width=width, height=height, adaptive_min=ADAPTIVE_MIN,
                                adaptive_max_factor=ADAPTIVE_MAX_FACTOR)
            stepped = sharded_render_step(scene_r, settings, acfg, shard_work(work, mesh), SEED,
                                          env_r, mesh)  # moments to allocate from
            lum2 = shard_array(torch.ones(work.u.shape[0], device=device), mesh)
            out.append(no_sync_step(f"{kind} {shape} adaptive step under sync debug 'error'",
                                    lambda: sharded_adaptive_render_step(
                                        scene_r, settings, acfg, stepped, lum2, SEED, env_r,
                                        mesh)))
    return out


def no_sync_step(name: str, step) -> dict:
    """``step`` (warmed up) under set_sync_debug_mode("error"): any host
    sync raises."""
    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
        err = ""
    except RuntimeError as e:
        err = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return {"name": name, "ok": not err, "error": err}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    p.add_argument("--size", default=f"{WIDTH}x{HEIGHT}", help="WIDTHxHEIGHT")
    p.add_argument("--spp", type=int, default=SPP, help="samples a step")
    p.add_argument("--devices", default="",
                   help="comma-separated GPUs for the 2x1 and 1x2 meshes on distinct devices "
                        "(e.g. cuda:0,cuda:1); default: none")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("validate_mesh: CUDA is not available (use --device cpu)")
    from ..utils.devtime import card_line

    w, h = (int(x) for x in args.size.lower().split("x"))
    dev = torch.device(args.device)
    res = run_1x1(dev, w, h, args.spp) + run_virtual(dev, SHAPES, w, h, args.spp)
    if args.devices:
        devices = [torch.device(d) for d in args.devices.split(",")][:2]
        res += run_virtual(devices[0], ("2x1", "1x2"), w, h, args.spp, devices=devices)
    for c in res:
        extra = " ".join(f"{k}={v}" for k, v in c.items() if k not in ("name", "ok"))
        print(f"[{c['name']}] {'PASS' if c['ok'] else 'FAIL'} {extra}", flush=True)
    print(card_line(dev) if dev.type == "cuda" else "cpu", flush=True)
    print(json.dumps(res))
    return 0 if all(c["ok"] for c in res) else 1


if __name__ == "__main__":
    sys.exit(main())
