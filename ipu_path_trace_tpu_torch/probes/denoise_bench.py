"""``--denoise``'s preview-quality win.

Counterpart of ``scripts/denoise_bench.py``.  Protocol (trained NIF env
``assets/nif_w192e16``, the reference's tone map):

  1. ground truth per scene: a uniform render at ``--gt-spp`` (16384)
     samples a pixel (probes/_study.py's streams);
  2. a preview curve with checkpoints at 8, 32, 128 and 512 spp, and at
     each the tone-mapped RMSE of (a) the raw film and (b) the film
     filtered by ``film/denoise.py::denoise_hdr`` (guides from
     ``primary_features``, sigma_colour 0.5, 1 and 2) against the
     tone-mapped ground truth;
  3. the equal-quality multiplier, with no extrapolation: the deepest
     measured raw checkpoint the denoised image still beats, over the
     checkpoint's spp (``equal_quality_bounds``).

The metric is tone-mapped (exposure 0, gamma 2.2, ``film/film.py::
tone_map``) because the denoiser targets displayed previews.  Scenes: the
default scene and ``assets/scenes/glass_caustic.json``, at FOV 90.

    python3 -m ipu_path_trace_tpu_torch.probes.denoise_bench --out DIR [assets] \\
        [--width 1104 --height 1000 --gt-spp 16384] [--preview-spp 8,32,128,512] \\
        [--seed 0] [--device cuda|cpu]

writes ``DIR/denoise_bench.json`` with the keys of the JAX record
(``docs/DENOISE.json``, a TPU run: its seconds are not the port's).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

from . import _study

PREVIEW_SPP = (8, 32, 128, 512)
SIGMAS = (0.5, 1.0, 2.0)  # log-luminance edge-stop sweep (default 1.0)
MAX_STEP = 512  # preview samples per render step at most


def film_of(work, width: int, height: int) -> np.ndarray:
    """The step-normalised HDR of a running worklist (its sums over its
    counts), as scripts/denoise_bench.py::film_of builds it."""
    from ..film.film import Film

    film = Film(width, height)
    host = [t.cpu().numpy() for t in (work.u, work.v, work.r, work.g, work.b,
                                      work.sample_count)]
    film.accumulate_soa(*host)
    return film.hdr_at_step(1)


def ldr_rmse(a_hdr: np.ndarray, b_ldr: np.ndarray) -> float:
    """RMSE of a tone-mapped HDR against a tone-mapped reference in [0, 1]."""
    from ..film.film import tone_map

    la = tone_map(a_hdr, 1, 0.0, 2.2).astype(np.float32) / 255.0
    return float(np.sqrt(np.mean((la - b_ldr) ** 2)))


def equal_quality_bounds(raw_pts: list[dict], dn_pts: list[dict], sigmas) -> None:
    """Per denoised checkpoint, the deepest measured raw checkpoint its best
    sigma beats (``beats_measured_raw_spp``, 0 if none) and, where there
    is one, that spp over the checkpoint's (``sample_multiplier_lower_bound``);
    no fitted extrapolation (scripts/denoise_bench.py).  Fills ``dn_pts``."""
    for entry in dn_pts:
        best = min(entry[f"denoised_ldr_rmse_sigma{s}"] for s in sigmas)
        beaten = [p["spp"] for p in raw_pts if p["ldr_rmse"] > best]
        entry["beats_measured_raw_spp"] = max(beaten) if beaten else 0
        if beaten:
            entry["sample_multiplier_lower_bound"] = round(max(beaten) / entry["spp"], 1)


def run_scene(name: str, scene, env, args, dev, log) -> dict:
    from ..core.records import make_worklist
    from ..film.denoise import denoise_hdr, primary_features
    from ..film.film import tone_map
    from ..render.params import StaticConfig

    w, h = args.width, args.height
    cfg = StaticConfig(width=w, height=h)
    wl = make_worklist(w, h)
    t0 = time.perf_counter()
    gt_step = min(_study.GT_STEP, args.gt_spp)
    b = _study.base(args.seed, _study.GT_TAG)
    work = _study.uniform_steps(scene, env, cfg, _study.batch(wl, dev), gt_step,
                                (_study.step_seed(b, s) for s in range(args.gt_spp // gt_step)))
    gt_ldr = tone_map(film_of(work, w, h), 1, 0.0, 2.2).astype(np.float32) / 255.0
    gt_s = time.perf_counter() - t0
    log(f"[{name}] ground truth {args.gt_spp} spp in {gt_s:.1f} s")
    guides = primary_features(scene, w, h, math.radians(_study.FOV), env=env)

    work = _study.batch(wl, dev)
    b = _study.base(args.seed, _study.CURVE_TAG)
    spp_done = 0
    raw_pts, dn_pts = [], []
    filter_s = filter_dev = None
    for target in args.preview_spp:
        while spp_done < target:
            step_spp = min(MAX_STEP, target - spp_done)
            work = _study.uniform_steps(scene, env, cfg, work, step_spp,
                                        [_study.step_seed(b, spp_done)])
            spp_done += step_spp
        hdr = film_of(work, w, h)
        raw = ldr_rmse(hdr, gt_ldr)
        raw_pts.append({"spp": target, "ldr_rmse": raw})
        entry = {"spp": target, "raw_ldr_rmse": raw}
        for sig in SIGMAS:
            window = _study.Window(dev)
            with window:
                dn = denoise_hdr(hdr, guides, sigma_colour=sig)
            filter_s, filter_dev = window.wall, window.device
            entry[f"denoised_ldr_rmse_sigma{sig}"] = ldr_rmse(dn, gt_ldr)
        dn_pts.append(entry)
        log(f"[{name}] {target:4d} spp: raw {raw:.4f}  " + "  ".join(
            f"s{s}={entry[f'denoised_ldr_rmse_sigma{s}']:.4f}" for s in SIGMAS))
    equal_quality_bounds(raw_pts, dn_pts, SIGMAS)
    return {"raw": raw_pts, "denoised": dn_pts,
            # The host clock around one denoise_hdr call (the filter runs on
            # the render's device; the HDR goes up and the result comes back).
            "filter_seconds_per_frame_host": round(filter_s, 4),
            "filter_device_seconds": None if filter_dev is None else round(filter_dev, 5),
            "ground_truth_seconds": round(gt_s, 3)}


def run(args) -> dict:
    from ..core.scene import default_scene
    from ..core.scenefile import load_scene

    dev = _study.device_of(args.device, "denoise_bench")
    env = _study.load_env(args.assets, dev)
    smi = _study.card(dev)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(f"device: {smi}, frame {args.width}x{args.height}, assets {args.assets}")
    result = {
        "frame": [args.width, args.height], "assets": os.path.basename(args.assets.rstrip("/")),
        "gt_spp": args.gt_spp, "sigmas": list(SIGMAS),
        "metric": "rmse of (x*2^0)^(1/2.2) tone-mapped images vs the "
                  "tone-mapped ground truth (displayed-preview quality)",
        "scenes": {}, "seed": args.seed, "device": smi,
    }
    scenes = {"default": default_scene(dev),
              "glass_caustic": load_scene(str(_study.SCENES / "glass_caustic.json"), dev)}
    for name, scene in scenes.items():
        result["scenes"][name] = run_scene(name, scene, env, args, dev, log)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="denoise_bench", description=__doc__.split("\n")[0])
    _study.add_common(ap)
    ap.add_argument("--width", type=int, default=1104)
    ap.add_argument("--height", type=int, default=1000)
    ap.add_argument("--gt-spp", type=int, default=16384)
    ap.add_argument("--preview-spp", default=",".join(map(str, PREVIEW_SPP)),
                    type=lambda s: tuple(int(x) for x in s.split(",")))
    args = ap.parse_args(argv)
    out = _study.out_dir(args.out)
    result = run(args)
    path = _study.write_json(out, "denoise_bench.json", result)
    summary = {s: [{"spp": e["spp"], "beats_raw_spp": e.get("beats_measured_raw_spp"),
                    "mult_lower_bound": e.get("sample_multiplier_lower_bound")}
                   for e in v["denoised"]] for s, v in result["scenes"].items()}
    print(json.dumps({"equal_quality_bounds": summary, "written": str(path)}))
    finite = np.isfinite([e[k] for v in result["scenes"].values() for e in v["denoised"]
                          for k in e if "rmse" in k]).all()
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
