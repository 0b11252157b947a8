"""GPU smoke check of the PyTorch/CUDA port: build, check, run, time.

    python3 chip_smoke.py          # from the root of a checkout, one CUDA GPU

Phases, one line each:
  1. device   - needs CUDA; prints nvidia-smi's name and power limit;
  2. build    - compiles the kernels from csrc/ (nvcc, sm_90a) and loads them;
  3. K1       - trace kernel vs its plain version, host noise and Philox,
                256x256, L=10;
  4. K2       - env-shade kernel vs its plain version on the canonical NIF
                and on the mixed-width one, 65,536 numpy-seeded escapes;
  5. K3       - megastep kernel vs its plain version, host noise, 256x256,
                4 samples;
  6. main     - the CLI (runtime/cli.main) at 1104x1000, 16 spp in steps of
                8, on assets/urban_alley_synth_nif, fused and unfused, with
                the kernels' launch counters; the app's log (each step's and
                each save's seconds) goes to stdout;
  7. full frame - at the main path's shapes (1104x1000, a ragged last
                block): K1 (Philox) and K2 (on that sample's escapes) and K3
                (Philox, 8 samples) vs their plain versions, then each kernel
                and its plain version per full-frame sample (CUDA events,
                after warm-up).
Then a JSON line with the kernels, the nvidia-smi line again, and the last
line {"ok": true, "device": {...}}.  Any failed check exits non-zero and
prints no result.  Tolerances are the reference's own:
  * tangent rays may flip between hit and miss under another compiler, so
    escaped/path_len must agree on >= 99.5% of lanes, and the other lanes'
    floats are held to the trace test's rtol 1e-4 / atol 3e-5
    (tests/test_trace_pallas.py, tests/test_megastep.py:79-90);
  * the NIF chain to median relative error 5e-3 and max 8e-2
    (tests/test_nif_pallas.py: bf16 features may round on opposite sides
    of an ulp and the log decode exponentiates the gap).
"""

from __future__ import annotations

import json
import logging
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ASSET = "assets/urban_alley_synth_nif"
MIXED_ASSET = "assets/nif_m128-128-80-128-128-128"  # per-layer widths, skip at 80 + 48
MAIN_W, MAIN_H, MAIN_SPP, MAIN_SPS = 1104, 1000, 16, 8
FLIP_FRACTION = 5e-3
TRACE_RTOL, TRACE_ATOL = 1e-4, 3e-5
NIF_MEDIAN, NIF_MAX = 5e-3, 8e-2

failures: list[str] = []


def phase(name: str, ok: bool, **info) -> None:
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{name}] {'PASS' if ok else 'FAIL'} {fields}", flush=True)
    if not ok:
        failures.append(name)


def nvidia_smi() -> str:
    """The card's name and power limit; every time printed here needs them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise SystemExit("chip_smoke: nvidia-smi not found; the card's name and power "
                         "limit go beside every number")
    res = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        raise SystemExit(f"chip_smoke: nvidia-smi failed (rc {res.returncode}): "
                         f"{res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the current stream, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace_check(name, got, ref, fields=("radiance", "esc_w", "esc_dir")):
    """The flip rule plus the trace tolerance on the unflipped lanes."""
    flipped = (got.path_len != ref.path_len) | (got.escaped != ref.escaped)
    ok_lanes = ~flipped
    frac = float(flipped.float().mean())
    err, bad = 0.0, 0
    for f in fields:
        a, b = getattr(got, f).stack()[:, ok_lanes], getattr(ref, f).stack()[:, ok_lanes]
        err = max(err, float((a - b).abs().max()))
        bad += int(((a - b).abs() > TRACE_ATOL + TRACE_RTOL * b.abs()).sum())
    phase(name, frac < FLIP_FRACTION and bad == 0, flipped_fraction=f"{frac:.2e}",
          out_of_tolerance=bad, max_abs_err=f"{err:.3e}")
    return err


def nif_rel(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    scale = ref.abs().max()
    rel = (got - ref).abs() / (ref.abs() + 1e-2 * scale)
    return float(rel.median()), float(rel.max())


def shade_check(name, model, esc_dir, esc_w, azimuth) -> float:
    """K2 against its plain version with the NIF budget."""
    from ipu_path_trace_tpu_torch.ops import nif

    got = nif.nif_env_shade(model, esc_dir, esc_w, azimuth).stack()
    ref = nif.nif_env_shade_plain(model, esc_dir, esc_w, azimuth).stack()
    med, mx = nif_rel(got, ref)
    err = float((got - ref).abs().max())
    phase(name, med < NIF_MEDIAN and mx < NIF_MAX and bool(torch.isfinite(got).all()),
          median_rel=f"{med:.2e}", max_rel=f"{mx:.2e}", max_abs_err=f"{err:.3e}")
    return err


def megastep_check(name, got, ref) -> float:
    """K3 against its plain version: the flip rule on the path-length sums,
    the NIF budget on the radiance of the other lanes."""
    flipped = got.path_len != ref.path_len
    frac = float(flipped.float().mean())
    a, b = got.radiance.stack()[:, ~flipped], ref.radiance.stack()[:, ~flipped]
    med, mx = nif_rel(a, b)
    err = float((a - b).abs().max())
    phase(name, frac < FLIP_FRACTION and med < NIF_MEDIAN and mx < NIF_MAX
          and bool(torch.isfinite(got.radiance.stack()).all()),
          flipped_fraction=f"{frac:.2e}", median_rel=f"{med:.2e}", max_rel=f"{mx:.2e}",
          max_abs_err=f"{err:.3e}")
    return err


def frame_luminance(exr_path: Path) -> tuple[float, float, np.ndarray]:
    """Mean luminance of a saved frame and a conservative Monte-Carlo
    standard error of it: pixel noise variance is bounded by half the
    mean squared difference of horizontal neighbours (image structure
    only adds to that bound)."""
    from ipu_path_trace_tpu_torch.film.imageio import read_exr

    hdr = read_exr(str(exr_path))
    lum = 0.2126 * hdr[..., 0] + 0.7152 * hdr[..., 1] + 0.0722 * hdr[..., 2]
    var = 0.5 * float(np.mean((lum[:, 1:] - lum[:, :-1]) ** 2))
    return float(lum.mean()), math.sqrt(var / lum.size), hdr


def main() -> None:
    # 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this check runs on a GPU")
    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    print(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    print(smi, flush=True)

    from ipu_path_trace_tpu_torch.core.records import to_device_batch
    from ipu_path_trace_tpu_torch.core.scene import default_scene
    from ipu_path_trace_tpu_torch.core.vecmath import Vec3
    from ipu_path_trace_tpu_torch.models.nif import load_nif_assets
    from ipu_path_trace_tpu_torch.ops import _lib, megastep, nif, trace
    from ipu_path_trace_tpu_torch.render.params import RenderSettings
    from ipu_path_trace_tpu_torch.runtime import cli
    from ipu_path_trace_tpu_torch.runtime.worklist import coherent_order, create_tracing_jobs

    # 2. build -------------------------------------------------------------
    t0 = time.monotonic()
    lib_path = _lib.build()
    _lib.library()
    build_s = time.monotonic() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    phase("build", True, seconds=f"{build_s:.1f}", library=lib_path.name)
    for ln in ptxas:
        print(f"  ptxas: {ln}")

    scene = default_scene(dev)
    model, _, _ = load_nif_assets(str(ROOT / ASSET), torch.bfloat16, dev)
    gen = np.random.default_rng(2024)

    def grid(w, h):
        wl = coherent_order(create_tracing_jobs(w, h), scene, w, h, 90.0)
        work = to_device_batch(wl, dev)
        return work.u.float(), work.v.float()

    # 3. K1 ------------------------------------------------------------------
    L = 10
    cols, rows = grid(256, 256)
    p = cols.shape[0]
    noise = gen.uniform(0.0, 1.0, (4 + 4 * L, p)).astype(np.float32)
    noise[0:2] = gen.normal(size=(2, p))
    noise_t = torch.from_numpy(noise).to(dev)
    settings = RenderSettings.make(samples_per_step=4)
    kw = dict(width=256, height=256, max_path_length=L)
    k1_err = trace_check(
        "K1 host-noise",
        trace.trace_sample(scene, settings, cols, rows, noise=noise_t, **kw),
        trace.trace_sample_plain(scene, settings, cols, rows, noise=noise_t, **kw))
    k1_err = max(k1_err, trace_check(
        "K1 philox",
        trace.trace_sample(scene, settings, cols, rows, (11, 22), sample_index=3, **kw),
        trace.trace_sample_plain(scene, settings, cols, rows, (11, 22), sample_index=3, **kw)))

    # 4. K2 ------------------------------------------------------------------
    n2 = 65_536
    d = gen.normal(size=(3, n2)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    escaped = gen.uniform(size=n2) < 0.8
    d[:, ~escaped] = 0.0
    w = gen.uniform(0.0, 2.0, (3, n2)).astype(np.float32)
    w[:, ~escaped] = 0.0
    esc_dir = Vec3.unstack(torch.from_numpy(d).to(dev))
    esc_w = Vec3.unstack(torch.from_numpy(w).to(dev))
    mixed, _, _ = load_nif_assets(str(ROOT / MIXED_ASSET), torch.bfloat16, dev)
    k2_err = max(shade_check("K2", model, esc_dir, esc_w, 0.7),
                 shade_check("K2 mixed-width", mixed, esc_dir, esc_w, 0.7))

    # 5. K3 ------------------------------------------------------------------
    s3 = 4
    noise3 = gen.uniform(0.0, 1.0, (s3, 4 + 4 * L, p)).astype(np.float32)
    noise3[:, 0:2] = gen.normal(size=(s3, 2, p))
    noise3_t = torch.from_numpy(noise3).to(dev)
    k3_err = megastep_check(
        "K3 host-noise",
        megastep.render_megastep(scene, settings, model, cols, rows, noise=noise3_t, **kw),
        megastep.render_megastep_plain(scene, settings, model, cols, rows, noise=noise3_t,
                                       **kw))

    # 6. main path through the CLI ------------------------------------------
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    counters = (trace.trace_sample, nif.nif_env_shade, megastep.render_megastep)
    plains = (trace.trace_sample_plain, nif.nif_env_shade_plain, megastep.render_megastep_plain)
    for f in counters:
        f.launches = 0
    for f in plains:
        f.cuda_runs = 0
    steps = MAIN_SPP // MAIN_SPS
    runs = {}
    # The app's per-step and per-save seconds, on stdout (cli.main's own
    # logging set-up then keeps this handler).
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="  app: %(asctime)s %(message)s")
    for fused in (True, False):
        before = [f.launches for f in counters]
        png = out_dir / f"main_{'fused' if fused else 'unfused'}.png"
        argv = ["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPP),
                "--samples-per-step", str(MAIN_SPS), "--assets", str(ROOT / ASSET),
                "-o", str(png)]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = cli.main(argv, use_fused_step=fused)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        delta = [f.launches - b for f, b in zip(counters, before)]
        mean, se, hdr = frame_luminance(png.with_suffix(".exr"))
        want = [0, 0, steps] if fused else [MAIN_SPP, MAIN_SPP, 0]
        runs[fused] = (mean, se)
        phase(f"main {'fused' if fused else 'unfused'}",
              rc == 0 and delta == want and bool(np.isfinite(hdr).all()) and hdr.shape ==
              (MAIN_H, MAIN_W, 3),
              launches_trace_shade_megastep=delta, mean_luminance=f"{mean:.6f}",
              mc_se=f"{se:.2e}",
              mpaths_per_s_incl_setup=f"{MAIN_W * MAIN_H * MAIN_SPP / secs / 1e6:.2f}",
              wall_s=f"{secs:.2f}")
    launches = {f.__name__: f.launches for f in counters}
    plain_cuda = {f.__name__: f.cuda_runs for f in plains}
    gap = abs(runs[True][0] - runs[False][0])
    bound = 5.0 * math.hypot(runs[True][1], runs[False][1])
    phase("main counters+agreement",
          all(v > 0 for v in launches.values()) and not any(plain_cuda.values())
          and gap <= bound, launches=launches, plain_runs_on_cuda=plain_cuda,
          luminance_gap=f"{gap:.3e}", bound_5se=f"{bound:.3e}")

    # 7. checks and timing at the main path's shapes ------------------------
    # 1,104,000 lanes end in a partial block, so the kernels' tail masks run
    # here.  These launches come after the counters were read above.
    cols, rows = grid(MAIN_W, MAIN_H)
    settings = RenderSettings.make(samples_per_step=MAIN_SPS)
    kw = dict(width=MAIN_W, height=MAIN_H, max_path_length=10)
    seed = (5, 6)
    esc = trace.trace_sample(scene, settings, cols, rows, seed, **kw)
    k1_err = max(k1_err, trace_check(
        "K1 philox 1104x1000", esc,
        trace.trace_sample_plain(scene, settings, cols, rows, seed, **kw)))
    k2_err = max(k2_err, shade_check("K2 1104x1000 escapes", model, esc.esc_dir, esc.esc_w,
                                     settings.azimuth))
    k3_err = max(k3_err, megastep_check(
        f"K3 philox 1104x1000 {MAIN_SPS} samples",
        megastep.render_megastep(scene, settings, model, cols, rows, seed, **kw),
        megastep.render_megastep_plain(scene, settings, model, cols, rows, seed, **kw)))
    times = {}

    def turns(name, kernel, plain, k_reps, p_reps, k_per=1):
        """plain, kernel, kernel, plain: the two versions in turns, one card;
        ms per full-frame sample (a kernel launch may render k_per)."""
        a = cuda_ms(plain, p_reps)
        b = cuda_ms(kernel, k_reps)
        c = cuda_ms(kernel, k_reps)
        e = cuda_ms(plain, p_reps)
        times[name] = ((b + c) / 2 / k_per, (a + e) / 2)
        print(f"[timing] {name}: kernel {times[name][0]:.3f} ms, plain "
              f"{times[name][1]:.3f} ms per full-frame sample", flush=True)

    turns("trace",
          lambda: trace.trace_sample(scene, settings, cols, rows, seed, **kw),
          lambda: trace.trace_sample_plain(scene, settings, cols, rows, seed, **kw), 10, 2)
    turns("env_shade",
          lambda: nif.nif_env_shade(model, esc.esc_dir, esc.esc_w, settings.azimuth),
          lambda: nif.nif_env_shade_plain(model, esc.esc_dir, esc.esc_w, settings.azimuth),
          10, 2)
    one = settings._replace(samples_per_step=1)
    turns("megastep",  # kernel: 8-sample launches, as the main path; plain: 1 sample
          lambda: megastep.render_megastep(scene, settings, model, cols, rows, seed, **kw),
          lambda: megastep.render_megastep_plain(scene, one, model, cols, rows, seed, **kw),
          3, 2, k_per=MAIN_SPS)
    mpaths = MAIN_W * MAIN_H / times["megastep"][0] / 1e3
    print(f"[timing] fused step device rate: {mpaths:.1f} Mpaths/s (information only)")

    rows_out = [
        ("trace", "ipu_path_trace_tpu_torch/csrc/trace.cu",
         "ipu_path_trace_tpu/ops/trace_pallas.py:549", launches["trace_sample"], k1_err),
        ("env_shade", "ipu_path_trace_tpu_torch/csrc/nif.cu",
         "ipu_path_trace_tpu/ops/nif_pallas.py:432", launches["nif_env_shade"], k2_err),
        ("megastep", "ipu_path_trace_tpu_torch/csrc/megastep.cu",
         "ipu_path_trace_tpu/ops/megastep_pallas.py:433", launches["render_megastep"], k3_err),
    ]
    report = {"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep, "launches": nl,
         "max_abs_err": err, "ms": times[n][0], "plain_ms": times[n][1]}
        for n, src, rep, nl, err in rows_out]}
    if failures:
        raise SystemExit(f"chip_smoke: failed phases: {failures}")
    (out_dir / "report.json").write_text(json.dumps(
        {**report, "nvidia_smi": smi, "build_seconds": build_s, "ptxas": ptxas}, indent=1))
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
