"""Accuracy acceptance: the port's render against the NumPy oracle, per config.

Port of ``scripts/validate_rmse.py``: one entry per reference
configuration, the same four, sizes, sample counts, seed, settings and
pass criteria:

  north_star      default scene, constant env, 512x512 @ 1000 spp
                  (absolute full-image RMSE <= 1e-3)
  config1_diffuse diffuse-only default scene, constant env, 512x512 @ 64 spp
  config2_texture full BSDF set + equirect HDRI texture env at 1104x1000
                  @ 4 spp (assets/procedural_sky.exr)
  config3_nif     full BSDF set + trained NIF env at 1104x1000 @ 2 spp
                  (assets/procedural_sky_nif in f32), fused (K3) and
                  unfused (K1 + K2), each a row of its own

The render side is the port's ``render_step`` in host-noise mode on the
card (``device``; the plain versions on the CPU): K1 + ``eval_env`` for
the constant and texture envs, K3 or K1 + K2 on the f32 chain (tf32
``wgmma``) for the NIF.  The noise comes from a ``torch.Generator``
seeded with SEED through ``step_noise``, a step of samples at a time (a
whole north_star noise tensor would be ~46 GB).  The oracle side
(cpu/oracle.py, shares no code with the renderer) replays the very same
noise one sample at a time, each worker process regenerating the stream
and tracing its share of the pixels (the oracle is elementwise per
pixel; its arithmetic is unchanged).  Exact replay measures
implementation divergence rather than Monte-Carlo noise; lanes where a
float32 rounding difference flips a discontinuous branch diverge
chaotically and are bounded and reported separately
(tests/test_oracle_parity.py).

    python3 -m ipu_path_trace_tpu_torch.probes.validate_rmse --out DIR \\
        [north_star config1_diffuse ...] [--device cuda|cpu] [--workers N] [--size WxH]

writes ``DIR/rmse.json`` (never ``docs/RMSE.json``, the JAX package's record).
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 7
ROOT = Path(__file__).resolve().parents[2]
STEP_SAMPLES = 8  # samples per render step (host noise per step: S x 44 x P floats)
# tests/test_oracle_parity.py's SETTINGS (the JAX script reads them from there).
SETTINGS = dict(fov=np.float32(np.pi / 2), aa_scale=np.float32(0.3), azimuth=np.float32(0.25),
                refractive_index=np.float32(1.5), stop_prob=np.float32(0.3), roulette_depth=3,
                max_path_length=10)
CONSTANT = (1.0, 0.8, 0.6)


def _diffuse_scene(device):
    """The default scene with every material DIFFUSE (the reference's config 1)."""
    from ..core.scene import Material, default_scene

    scene = default_scene(device)
    return scene._replace(material=torch.full_like(scene.material, int(Material.DIFFUSE)))


def _default_scene(device):
    from ..core.scene import default_scene

    return default_scene(device)


def _constant_env(device):
    from ..models.envlight import ConstantEnv

    return ConstantEnv(colour=CONSTANT), ("constant", np.asarray(CONSTANT, np.float32))


def _texture_env(device):
    from ..film.imageio import read_exr
    from ..models.envlight import TextureEnv

    tex = read_exr(str(ROOT / "assets" / "procedural_sky.exr"))
    return TextureEnv(texture=torch.from_numpy(tex).to(device)), ("texture", tex)


def _nif_env(device):
    from ..models.envlight import NifEnv
    from ..models.nif import load_nif_assets

    model, meta, weights = load_nif_assets(str(ROOT / "assets" / "procedural_sky_nif"),
                                           torch.float32, device)
    return NifEnv(model=model), ("nif", weights, meta)


CONFIGS = {
    # name: (width, height, spp, scene_fn, env_fn, baseline_label)
    "north_star": (512, 512, 1000, _default_scene, _constant_env,
                   "rmse <= 1e-3 at 1k spp (BASELINE.json north_star)"),
    "config1_diffuse": (512, 512, 64, _diffuse_scene, _constant_env,
                        "BASELINE config 1: diffuse sphere scene, 512x512, constant env, 64 spp"),
    "config2_texture": (1104, 1000, 4, _default_scene, _texture_env,
                        "BASELINE config 2: full BSDF + equirect HDRI texture env at 1104x1000"),
    "config3_nif": (1104, 1000, 2, _default_scene, _nif_env,
                    "BASELINE config 3: neural env light (trained NIF) fused into the shading "
                    "wavefront at 1104x1000"),
}


def paths(name: str) -> tuple[str, ...]:
    """The render paths a config is checked on: a NIF both fused (K3) and
    unfused (K1 + K2); the other envs have one (K1 + eval_env)."""
    return ("fused", "unfused") if name == "config3_nif" else ("unfused",)


def settings_for(spp: int):
    from ..render.params import RenderSettings

    return RenderSettings(
        fov=float(SETTINGS["fov"]), aa_scale=float(SETTINGS["aa_scale"]),
        azimuth=float(SETTINGS["azimuth"]), refractive_index=float(SETTINGS["refractive_index"]),
        stop_prob=float(SETTINGS["stop_prob"]), roulette_depth=SETTINGS["roulette_depth"],
        samples_per_step=spp, aperture=0.0, focal_distance=1.0)


def static_config(w: int, h: int, fused: bool = True):
    from ..render.params import StaticConfig

    return StaticConfig(width=w, height=h, max_path_length=SETTINGS["max_path_length"],
                        use_fused_step=fused)


def worklist(w: int, h: int) -> tuple[np.ndarray, np.ndarray]:
    """The frame's lanes in the worklist's order: (cols, rows) f32."""
    from ..core.records import make_worklist

    wl = make_worklist(w, h)
    return wl["u"].astype(np.float32), wl["v"].astype(np.float32)


def kernel_launches() -> dict:
    """The launch counters of the kernels a render step can run."""
    from ..ops import megastep, nif, trace

    return {"trace": trace.trace_sample.launches, "env_shade": nif.nif_env_shade.launches,
            "megastep": megastep.render_megastep.launches, "nif_apply": nif.nif_apply_t.launches}


def render_port(name: str, w: int, h: int, spp: int, device, fused: bool) -> np.ndarray:
    """(P, 3) per-lane mean radiance of the port's render_step in host-noise
    mode, SEED's stream drawn a step at a time."""
    from ..core.records import make_worklist, to_device_batch
    from ..render.wavefront import render_step, step_noise

    _, _, _, scene_fn, env_fn, _ = CONFIGS[name]
    dev = torch.device(device)
    scene = scene_fn(dev)
    env, _ = env_fn(dev)
    cfg = static_config(w, h, fused)
    work = to_device_batch(make_worklist(w, h), dev)
    n = work.u.shape[0]
    gen = torch.Generator().manual_seed(SEED)
    for s0 in range(0, spp, STEP_SAMPLES):
        count = min(STEP_SAMPLES, spp - s0)
        noise = step_noise(gen, n, cfg, count, dev)
        work = render_step(scene, settings_for(count), cfg, work, None, env, noise=noise)
    rgb = torch.stack([work.r, work.g, work.b], -1).cpu().numpy()
    return rgb / spp


def _oracle_part(name: str, w: int, h: int, spp: int, lo: int, hi: int) -> np.ndarray:
    """The oracle's per-lane radiance sum for lanes lo..hi: SEED's stream
    regenerated sample by sample (the draws step_noise makes), each
    sample's rows of these lanes traced by trace_sample_oracle."""
    from ..cpu import oracle_scene_from, oracle_streams, trace_sample_oracle
    from ..render.wavefront import sample_noise

    _, _, _, scene_fn, env_fn, _ = CONFIGS[name]
    oscene = oracle_scene_from(scene_fn("cpu"))
    _, env = env_fn("cpu")
    cols, rows = worklist(w, h)
    n = cols.shape[0]
    cfg = static_config(w, h)
    gen = torch.Generator().manual_seed(SEED)
    acc = np.zeros((hi - lo, 3), np.float32)
    for _ in range(spp):
        aa, _lens, uniforms = oracle_streams(sample_noise(gen, n, cfg)[:, lo:hi].numpy())
        rad, _ = trace_sample_oracle(
            oscene, cols[lo:hi], rows[lo:hi], w, h, fov=SETTINGS["fov"],
            aa_scale=SETTINGS["aa_scale"], azimuth=SETTINGS["azimuth"],
            refractive_index=SETTINGS["refractive_index"], stop_prob=SETTINGS["stop_prob"],
            roulette_depth=SETTINGS["roulette_depth"],
            max_path_length=SETTINGS["max_path_length"], aa=aa, uniforms=uniforms, env=env)
        acc += rad
    return acc


@functools.lru_cache(maxsize=2)
def render_oracle_lanes(name: str, w: int, h: int, spp: int, workers: int = 1) -> np.ndarray:
    """(P, 3) per-lane mean radiance of the oracle; the lanes split over
    ``workers`` processes (1: in this process).  Cached: a config's paths
    share it."""
    n = w * h
    if workers <= 1:
        return _oracle_part(name, w, h, spp, 0, n) / spp
    bounds = np.linspace(0, n, workers + 1).astype(int)
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                                            "OPENBLAS_NUM_THREADS")}
    os.environ.update({k: "1" for k in saved})  # one thread a worker, inherited at spawn
    try:
        import multiprocessing

        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                 initializer=torch.set_num_threads, initargs=(1,)) as ex:
            parts = list(ex.map(_oracle_part, [name] * workers, [w] * workers, [h] * workers,
                                [spp] * workers, bounds[:-1], bounds[1:]))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return np.concatenate(parts) / spp


def metrics(name: str, img: np.ndarray, ref: np.ndarray) -> dict:
    """The JAX script's numbers and pass rule for port image ``img``
    against oracle image ``ref`` ((P, 3) or (H, W, 3))."""
    scale = max(float(np.abs(ref).max()), 1.0)
    diff = (img - ref) / scale
    rmse = float(np.sqrt(np.mean(diff ** 2)))
    diverged = np.abs(diff).max(axis=-1) > 1e-2
    agree_rmse = float(np.sqrt(np.mean(diff[~diverged] ** 2)))
    abs_rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
    if name == "north_star":
        criterion = "absolute full-image rmse <= 1e-3 at 1k spp (BASELINE.json north_star)"
        passed = bool(abs_rmse <= 1e-3)
    else:
        criterion = ("normalised rmse_agreeing_lanes <= 1e-3, diverged fraction < 0.5%, "
                     "normalised full rmse <= 2e-2")
        passed = bool(agree_rmse <= 1e-3 and float(diverged.mean()) < 0.005 and rmse <= 2e-2)
    return {"scale": scale, "rmse": rmse, "rmse_absolute": abs_rmse,
            "rmse_agreeing_lanes": agree_rmse, "diverged_pixel_fraction": float(diverged.mean()),
            "criterion": criterion, "pass": passed}


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu, plain versions"


def run_config(name: str, size_override: tuple[int, int] | None = None, device="cuda",
               path: str | None = None, workers: int = 1, spp_override: int | None = None) -> dict:
    """Render one config on the port (``path``: "fused" or "unfused"; the
    config's first by default) and on the oracle, and compare.
    ``size_override`` shrinks the frame and ``spp_override`` the sample
    count, keeping the criterion."""
    w, h, spp, scene_fn, env_fn, label = CONFIGS[name]
    if size_override is not None:
        w, h = size_override
    spp = spp_override or spp
    path = path or paths(name)[0]
    if path not in paths(name):
        raise ValueError(f"{name} has no {path!r} path (it has {paths(name)})")
    t0 = time.monotonic()
    before = kernel_launches()
    img = render_port(name, w, h, spp, device, path == "fused")
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    render_s = time.monotonic() - t0
    t0 = time.monotonic()
    ref = render_oracle_lanes(name, w, h, spp, workers)
    oracle_s = time.monotonic() - t0
    return {
        "config": name, "baseline": label,
        "scene": "diffuse-only default" if scene_fn is _diffuse_scene else
                 "default (codelets.cpp:111-144)",
        "env": env_fn.__name__.strip("_").split("_")[0],
        "width": w, "height": h, "spp": spp, "seed": SEED,
        **metrics(name, img, ref),
        "device": device_name(device), "path": path,
        "kernels": ("K3" if path == "fused" else "K1 + K2") if name == "config3_nif"
                   else "K1 + eval_env",
        "launches": launches,
        "render_seconds": render_s, "oracle_seconds": oracle_s,
        "note": "exact stream replay (host noise from a seeded torch.Generator) vs the "
                "port's independent NumPy oracle; diverged pixels are chaotic branch flips "
                "at float32 discontinuities",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="validate_rmse")
    ap.add_argument("configs", nargs="*", help=f"any of {', '.join(CONFIGS)} (default: all)")
    ap.add_argument("--out", required=True, help="directory for rmse.json")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' renders with the kernels; 'cpu' with their plain versions")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                    help="oracle processes (the pixels split between them)")
    ap.add_argument("--size", default=None, help="WxH in place of each config's frame")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("validate_rmse: CUDA is not available; --device cpu runs the plain "
                         "versions")
    unknown = sorted(set(args.configs) - set(CONFIGS))
    if unknown:
        ap.error(f"unknown configs {unknown}; choose from {list(CONFIGS)}")
    size = tuple(int(x) for x in args.size.split("x")) if args.size else None
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    entries, ok = [], True
    for name in args.configs or list(CONFIGS):
        for path in paths(name):
            entry = run_config(name, size, args.device, path, args.workers)
            ok &= entry["pass"]
            entries.append(entry)
            print(json.dumps(entry), flush=True)
            (out_dir / "rmse.json").write_text(json.dumps(entries, indent=2))
    print(f"wrote {out_dir / 'rmse.json'} ({len(entries)} entries)", file=sys.stderr)
    return 0 if ok and all(math.isfinite(e["rmse"]) for e in entries) else 1


if __name__ == "__main__":
    raise SystemExit(main())
