"""On-card validation: the main path's render against a reference, statistically.

Counterpart of ``scripts/validate_tpu.py``, with its three checks, its
``rmse`` (normalised by the larger peak) and its rule: a candidate whose
RMSE against a reference render (``cross``) stays under 1.5 x the
Monte-Carlo noise floor (the RMSE between two independent reference
renders) + 1e-4 is unbiased; a biased one sits above it.  The TPU's pair
was its hardware PRNG against counter streams; here:

  * the reference: host-noise renders from ``torch.Generator``s seeded 1
    and 2 (their floor), unfused - K1 + K2 for a NIF, K1 + ``eval_env``
    for the texture;
  * the candidate: the main path's mode, Philox in the kernel (seed 3),
    fused K3 for a NIF (Sobol: its Owen-Sobol rows).

The checks (``checks``):

  * nif-env at 128x128 @ 256 spp: the synthetic NIF
    (``models/nif.make_synthetic_nif``, bf16) as the script, then the
    canonical ``urban_alley_synth_nif`` in bf16, int8 (its QAT twin
    ``urban_alley_synth_nif_int8``) and f32, and in bf16 with
    ``--sampler sobol``;
  * texture-env at 1104x1000 @ max(16, spp // 8) (assets/procedural_sky.exr);
  * adaptive-vs-uniform at 512x512 @ 256 spp in 4 steps
    (``render/adaptive.py``; the floor two uniform renders, Philox seeds 1
    and 2), with the script's two assertions on ``sample_count``.

    python3 -m ipu_path_trace_tpu_torch.probes.validate_gpu --out DIR [--spp 256] \\
        [--device cuda|cpu]

writes ``DIR/validate_gpu.json``: per check its floor, cross and pass.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
CANONICAL = ROOT / "assets" / "urban_alley_synth_nif"
CANONICAL_INT8 = ROOT / "assets" / "urban_alley_synth_nif_int8"
STEP_SAMPLES = 32  # host-noise samples per step (the noise is S x 44 x P floats)
ADAPTIVE_STEPS = 4


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """scripts/validate_tpu.py::rmse: RMSE over the larger peak."""
    scale = max(np.abs(a).max(), np.abs(b).max(), 1e-9)
    return float(np.sqrt(np.mean((a - b) ** 2)) / scale)


def _mean(work) -> np.ndarray:
    """(P, 3) per-lane mean radiance (sums over the lane's samples)."""
    rgb = torch.stack([work.r, work.g, work.b], -1)
    return (rgb / work.sample_count.clamp_min(1)[:, None].to(rgb.dtype)).cpu().numpy()


def render(env, scene, w: int, h: int, spp: int, seed: int, *, host_noise: bool, fused: bool,
           sampler: str = "prng", device="cuda") -> np.ndarray:
    """One render of spp samples at w x h: host noise from a generator
    seeded ``seed`` (unfused: K1 + K2 or K1 + eval_env), or the kernels'
    Philox stream from that generator's seed words (``fused``: K3 for a
    NIF)."""
    from ..core.records import make_worklist, to_device_batch
    from ..render.params import RenderSettings, StaticConfig
    from ..render.wavefront import render_step, step_noise
    from ..runtime.app import step_seed

    dev = torch.device(device)
    cfg = StaticConfig(width=w, height=h, use_fused_step=fused, sampler=sampler)
    work = to_device_batch(make_worklist(w, h), dev)
    gen = torch.Generator().manual_seed(seed)
    if not host_noise:
        settings = RenderSettings.make(samples_per_step=spp, seed=seed)
        return _mean(render_step(scene, settings, cfg, work, step_seed(gen), env))
    for s0 in range(0, spp, STEP_SAMPLES):
        count = min(STEP_SAMPLES, spp - s0)
        noise = step_noise(gen, work.u.shape[0], cfg, count, dev)
        work = render_step(scene, RenderSettings.make(samples_per_step=count), cfg, work, None,
                           env, noise=noise)
    return _mean(work)


def render_adaptive(env, scene, w: int, h: int, spp: int, seed: int, *, adaptive: bool,
                    device="cuda", block_size: int | None = None) -> np.ndarray:
    """ADAPTIVE_STEPS fused steps of spp // ADAPTIVE_STEPS samples, Philox
    seeded per step from a generator seeded ``seed``: adaptive (budgets
    per ``block_size`` rays, ops/megastep.BUDGET_BLOCK by default, from the
    statistics; the script's assertions on the sample counts) or uniform."""
    from ..core.records import make_worklist, to_device_batch
    from ..ops.megastep import BUDGET_BLOCK
    from ..render.adaptive import adaptive_render_step
    from ..render.params import RenderSettings, StaticConfig
    from ..render.wavefront import render_step
    from ..runtime.app import step_seed

    dev = torch.device(device)
    cfg = StaticConfig(width=w, height=h)
    per = spp // ADAPTIVE_STEPS
    settings = RenderSettings.make(samples_per_step=per)
    work = to_device_batch(make_worklist(w, h), dev)
    lum2 = torch.zeros(work.u.shape[0], dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(ADAPTIVE_STEPS):
        if adaptive:
            work, lum2 = adaptive_render_step(scene, settings, cfg, work, lum2, step_seed(gen), env,
                                              block_size=block_size or BUDGET_BLOCK)
        else:
            work = render_step(scene, settings, cfg, work, step_seed(gen), env)
    if adaptive:
        counts = work.sample_count.cpu().numpy()
        # Step 1 is the uniform cold start; later steps never go below the floor.
        assert counts.min() >= per + 3 * min(cfg.adaptive_min, per), counts.min()
        assert counts.min() != counts.max(), "controller never adapted"
    return _mean(work)


def check(name: str, reference, candidate) -> dict:
    """floor = rmse(reference(1), reference(2)); cross = rmse(reference(1),
    candidate(3)); pass when cross < 1.5 floor + 1e-4."""
    t0 = time.monotonic()
    a, b, c = reference(1), reference(2), candidate(3)
    floor, cross = rmse(a, b), rmse(a, c)
    ok = bool(cross < 1.5 * floor + 1e-4 and np.isfinite(c).all())
    print(f"[{name}] floor {floor:.5f} cross {cross:.5f} {'PASS' if ok else 'FAIL'} "
          f"({time.monotonic() - t0:.1f} s)", flush=True)
    return {"name": name, "floor": floor, "cross": cross, "pass": ok}


def nif_envs(device) -> dict:
    """The NIF envs of the nif-env checks: the synthetic NIF in bf16 and
    the canonical asset in bf16, int8 and f32."""
    from ..models.envlight import NifEnv
    from ..models.nif import load_nif_assets, make_params, make_synthetic_nif
    from ..runtime.app import parse_env_assets

    dev = torch.device(device)
    weights, meta = make_synthetic_nif(0)
    return {"synthetic bf16": NifEnv(model=make_params(weights, meta, torch.bfloat16, dev)),
            "canonical bf16": NifEnv(model=load_nif_assets(str(CANONICAL), torch.bfloat16,
                                                           dev)[0]),
            "canonical int8": parse_env_assets(str(CANONICAL_INT8), dev, "int8")[0],
            "canonical f32": NifEnv(model=load_nif_assets(str(CANONICAL), torch.float32,
                                                          dev)[0])}


def checks(spp: int = 256, device="cuda", nif_size=(128, 128), texture_size=(1104, 1000),
           adaptive_size=(512, 512), adaptive_spp=None, adaptive_block=None) -> list[dict]:
    """Every check of the module docstring at the given sizes (the texture
    check at max(16, spp // 8) samples, the adaptive one at spp and
    ops/megastep.BUDGET_BLOCK rays a budget unless given)."""
    from ..core.scene import default_scene
    from ..film.imageio import read_exr
    from ..models.envlight import TextureEnv

    dev = torch.device(device)
    scene = default_scene(dev)
    out = []
    w, h = nif_size
    envs = nif_envs(dev)
    runs = [(f"nif-env {k}", e, "prng") for k, e in envs.items()]
    runs.append(("nif-env canonical bf16 sobol", envs["canonical bf16"], "sobol"))
    for name, env, sampler in runs:
        out.append(check(
            f"{name} {w}x{h} @ {spp} spp",
            lambda s, e=env: render(e, scene, w, h, spp, s, host_noise=True, fused=False,
                                    device=dev),
            lambda s, e=env, smp=sampler: render(e, scene, w, h, spp, s, host_noise=False,
                                                 fused=True, sampler=smp, device=dev)))
    tex = TextureEnv(texture=torch.from_numpy(read_exr(str(ROOT / "assets" /
                                                       "procedural_sky.exr"))).to(dev))
    w, h = texture_size
    tspp = max(16, spp // 8)
    out.append(check(
        f"texture-env {w}x{h} @ {tspp} spp",
        lambda s: render(tex, scene, w, h, tspp, s, host_noise=True, fused=False, device=dev),
        lambda s: render(tex, scene, w, h, tspp, s, host_noise=False, fused=False, device=dev)))
    w, h = adaptive_size
    env = envs["synthetic bf16"]
    aspp = adaptive_spp or spp
    out.append(check(
        f"adaptive-vs-uniform {w}x{h} @ {aspp} spp",
        lambda s: render_adaptive(env, scene, w, h, aspp, s, adaptive=False, device=dev),
        lambda s: render_adaptive(env, scene, w, h, aspp, s, adaptive=True, device=dev,
                                  block_size=adaptive_block)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="validate_gpu")
    ap.add_argument("--out", required=True, help="directory for validate_gpu.json")
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' renders with the kernels; 'cpu' with their plain versions")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("validate_gpu: CUDA is not available; --device cpu runs the plain "
                         "versions")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    res = checks(args.spp, dev)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu, plain versions"
    (out_dir / "validate_gpu.json").write_text(json.dumps({"device": device, "spp": args.spp,
                                                           "checks": res}, indent=2))
    print(json.dumps({"device": device, "checks": res}))
    return 0 if all(c["pass"] for c in res) else 1


if __name__ == "__main__":
    sys.exit(main())
