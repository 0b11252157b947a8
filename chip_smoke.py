"""GPU smoke check of the PyTorch/CUDA port: build, check, run, time.

    python3 chip_smoke.py          # from the root of a checkout, one CUDA GPU

Phases, one line each:
  1. device   - needs CUDA; prints nvidia-smi's name and power limit;
  2. build    - compiles the kernels from csrc/ (nvcc, sm_90a) and loads them;
  3. K1       - trace kernel vs its plain version, host noise and Philox,
                256x256, L=10;
  4. K2       - env-shade kernel vs its plain version on the canonical NIF
                and on the mixed-width one, 65,536 numpy-seeded escapes, and
                with the int8 chain on assets/urban_alley_synth_nif_int8;
  4b. K4      - NIF-apply kernel vs its plain version on 65,536 numpy-seeded
                (u, v): bf16 on the canonical and mixed-width assets, int8 on
                both (lattice-calibrated) and on the int8 asset (its QAT grids);
  5. K3       - megastep kernel vs its plain version, host noise, 256x256,
                4 samples, bf16 and int8;
  6. main     - the CLI (runtime/cli.main) at 1104x1000, 16 spp in steps of
                8: assets/urban_alley_synth_nif fused and unfused; the int8
                asset with --nif-precision int8 fused and unfused; and
                --nif-mode baked (bf16, then int8).  Every kernel's launch
                counter is set to 0 just before each run and read just after;
                the app's log (each step's, save's and bake's seconds) goes to
                stdout;
  7. full frame - at the main path's shapes (1104x1000, a ragged last
                block): K1 (Philox), K2 (on that sample's escapes, bf16 and
                int8), K3 (Philox, 8 samples, bf16 and int8) and K4 (one
                bake chunk of 10 rows of 4096, bf16 and int8) vs their plain
                versions, then each kernel and its plain version timed (CUDA
                events, after warm-up).
Then a JSON line with the kernels, the nvidia-smi line again, and the last
line {"ok": true, "device": {...}}.  Any failed check exits non-zero and
prints no result.  Tolerances are the reference's own:
  * tangent rays may flip between hit and miss under another compiler, so
    escaped/path_len must agree on >= 99.5% of lanes, and the other lanes'
    floats are held to the trace test's rtol 1e-4 / atol 3e-5
    (tests/test_trace_pallas.py, tests/test_megastep.py:79-90);
  * the bf16 NIF chain to median relative error 5e-3 and max 8e-2
    (tests/test_nif_pallas.py: bf16 features may round on opposite sides
    of an ulp and the log decode exponentiates the gap);
  * the int8 chain to median 1e-3 and max 8e-2, and the int8 env shade to
    median 1e-3, fewer than 1% of lanes above 1e-2 and max 0.5
    (tests/test_quant.py:126-127, 274-276: a feature next to a rounding tie
    may take a neighbouring int8 code).
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
INT8_ASSET = "assets/urban_alley_synth_nif_int8"  # the canonical 6x320 after QAT
MIXED_ASSET = "assets/nif_m128-128-80-128-128-128"  # per-layer widths, skip at 80 + 48
MAIN_W, MAIN_H, MAIN_SPP, MAIN_SPS = 1104, 1000, 16, 8
FLIP_FRACTION = 5e-3
TRACE_RTOL, TRACE_ATOL = 1e-4, 3e-5
NIF_MEDIAN, NIF_MAX = 5e-3, 8e-2
INT8_MEDIAN, INT8_SHADE_FRACTION, INT8_SHADE_MAX = 1e-3, 1e-2, 0.5
BAKE_ROWS = 30 * 1472 // 4096  # rows per bake chunk at the default --max-nif-batch-size

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


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Relative error, floored at 1% of the reference's peak."""
    return (got - ref).abs() / (ref.abs() + 1e-2 * ref.abs().max())


def nif_rel(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    rel = rel_err(got, ref)
    return float(rel.median()), float(rel.max())


def is_int8(model) -> bool:
    from ipu_path_trace_tpu_torch.models.quant import QuantNifModel

    return isinstance(model, QuantNifModel)


def shade_check(name, model, esc_dir, esc_w, azimuth) -> float:
    """K2 against its plain version with the NIF budget of the model's chain."""
    from ipu_path_trace_tpu_torch.ops import nif

    got = nif.nif_env_shade(model, esc_dir, esc_w, azimuth).stack()
    ref = nif.nif_env_shade_plain(model, esc_dir, esc_w, azimuth).stack()
    rel = rel_err(got, ref)
    med, mx = float(rel.median()), float(rel.max())
    above = float((rel > 1e-2).float().mean())
    err = float((got - ref).abs().max())
    if is_int8(model):
        ok = med < INT8_MEDIAN and above < INT8_SHADE_FRACTION and mx < INT8_SHADE_MAX
    else:
        ok = med < NIF_MEDIAN and mx < NIF_MAX
    phase(name, ok and bool(torch.isfinite(got).all()), median_rel=f"{med:.2e}",
          max_rel=f"{mx:.2e}", lanes_above_1e2=f"{above:.2e}", max_abs_err=f"{err:.3e}")
    return err


def apply_check(name, model, u, v) -> float:
    """K4 against its plain version with the NIF budget of the model's chain."""
    from ipu_path_trace_tpu_torch.ops import nif

    got = nif.nif_apply_t(model, u, v)
    ref = nif.nif_apply_t_plain(model, u, v)
    med, mx = nif_rel(got, ref)
    err = float((got - ref).abs().max())
    phase(name, med < (INT8_MEDIAN if is_int8(model) else NIF_MEDIAN) and mx < NIF_MAX
          and got.shape == (3, u.shape[0]) and bool(torch.isfinite(got).all()),
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
    from ipu_path_trace_tpu_torch.models.quant import quantize_nif
    from ipu_path_trace_tpu_torch.ops import _lib, megastep, nif, trace
    from ipu_path_trace_tpu_torch.render.params import RenderSettings
    from ipu_path_trace_tpu_torch.runtime import cli
    from ipu_path_trace_tpu_torch.runtime.app import parse_env_assets
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
    model, meta, weights = load_nif_assets(str(ROOT / ASSET), torch.bfloat16, dev)
    mixed, mixed_meta, mixed_weights = load_nif_assets(str(ROOT / MIXED_ASSET), torch.bfloat16,
                                                       dev)
    q8 = parse_env_assets(str(ROOT / INT8_ASSET), dev, "int8")[0].model  # the QAT grids
    q8_canonical = quantize_nif(weights, meta, device=dev)  # lattice-calibrated
    q8_mixed = quantize_nif(mixed_weights, mixed_meta, device=dev)
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
    err = {}
    err["env_shade"] = max(shade_check("K2", model, esc_dir, esc_w, 0.7),
                           shade_check("K2 mixed-width", mixed, esc_dir, esc_w, 0.7))
    err["env_shade_int8"] = max(shade_check("K2 int8", q8, esc_dir, esc_w, 0.7),
                                shade_check("K2 int8 mixed-width", q8_mixed, esc_dir, esc_w, 0.7))

    # 4b. K4 -----------------------------------------------------------------
    u, v = (torch.from_numpy(gen.uniform(0.0, 1.0, (2, n2)).astype(np.float32)).to(dev))
    err["nif_apply"] = max(apply_check("K4 bf16", model, u, v),
                           apply_check("K4 bf16 mixed-width", mixed, u, v))
    err["nif_apply_int8"] = max(apply_check("K4 int8", q8, u, v),
                                apply_check("K4 int8 canonical PTQ", q8_canonical, u, v),
                                apply_check("K4 int8 mixed-width", q8_mixed, u, v))

    # 5. K3 ------------------------------------------------------------------
    s3 = 4
    noise3 = gen.uniform(0.0, 1.0, (s3, 4 + 4 * L, p)).astype(np.float32)
    noise3[:, 0:2] = gen.normal(size=(s3, 2, p))
    noise3_t = torch.from_numpy(noise3).to(dev)
    for name, m in (("megastep", model), ("megastep_int8", q8)):
        err[name] = megastep_check(
            f"K3 {'int8 ' if is_int8(m) else ''}host-noise",
            megastep.render_megastep(scene, settings, m, cols, rows, noise=noise3_t, **kw),
            megastep.render_megastep_plain(scene, settings, m, cols, rows, noise=noise3_t,
                                           **kw))

    # 6. main path through the CLI ------------------------------------------
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    counters = (trace.trace_sample, nif.nif_env_shade, megastep.render_megastep,
                nif.nif_apply_t)
    plains = (trace.trace_sample_plain, nif.nif_env_shade_plain,
              megastep.render_megastep_plain, nif.nif_apply_t_plain)
    steps = MAIN_SPP // MAIN_SPS
    bake_chunks = -(-meta.image_shape[0] // BAKE_ROWS)
    int8_flags = ["--nif-precision", "int8"]
    # (name, asset, flags, fused, launches of trace, env shade, megastep, nif apply)
    runs = [
        ("main fused", ASSET, [], True, [0, 0, steps, 0]),
        ("main unfused", ASSET, [], False, [MAIN_SPP, MAIN_SPP, 0, 0]),
        ("main int8 fused", INT8_ASSET, int8_flags, True, [0, 0, steps, 0]),
        ("main int8 unfused", INT8_ASSET, int8_flags, False, [MAIN_SPP, MAIN_SPP, 0, 0]),
        ("main baked", ASSET, ["--nif-mode", "baked"], True, [MAIN_SPP, 0, 0, bake_chunks]),
        ("main baked int8", INT8_ASSET, int8_flags + ["--nif-mode", "baked"], True,
         [MAIN_SPP, 0, 0, bake_chunks]),
    ]
    lum, launches = {}, {}
    # The app's per-step, per-save and bake seconds, on stdout (cli.main's
    # own logging set-up then keeps this handler).
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="  app: %(asctime)s %(message)s")
    for name, asset, flags, fused, want in runs:
        png = out_dir / f"{name.replace(' ', '_')}.png"
        argv = ["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPP),
                "--samples-per-step", str(MAIN_SPS), "--assets", str(ROOT / asset),
                "-o", str(png), *flags]
        for f in counters:
            f.launches = 0
        for f in plains:
            f.cuda_runs = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = cli.main(argv, use_fused_step=fused)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        got = [f.launches for f in counters]
        plain_cuda = [f.cuda_runs for f in plains]
        launches[name] = dict(zip(("trace", "env_shade", "megastep", "nif_apply"), got))
        mean, se, hdr = frame_luminance(png.with_suffix(".exr"))
        lum[name] = (mean, se)
        phase(name, rc == 0 and got == want and not any(plain_cuda)
              and bool(np.isfinite(hdr).all()) and hdr.shape == (MAIN_H, MAIN_W, 3),
              launches_trace_shade_megastep_apply=got, plain_runs_on_cuda=plain_cuda,
              mean_luminance=f"{mean:.6f}", mc_se=f"{se:.2e}",
              mpaths_per_s_incl_setup=f"{MAIN_W * MAIN_H * MAIN_SPP / secs / 1e6:.2f}",
              wall_s=f"{secs:.2f}")

    def gap(a, b):
        return abs(lum[a][0] - lum[b][0]), 5.0 * math.hypot(lum[a][1], lum[b][1])

    for a, b in (("main fused", "main unfused"), ("main int8 fused", "main int8 unfused")):
        g, bound = gap(a, b)
        phase(f"{a} vs unfused", g <= bound, luminance_gap=f"{g:.3e}", bound_5se=f"{bound:.3e}")
    for a, b in (("main int8 fused", "main fused"), ("main baked", "main fused"),
                 ("main baked int8", "main int8 fused")):
        g, bound = gap(a, b)
        print(f"[gap] {a} vs {b}: mean luminance {lum[a][0]:.6f} vs {lum[b][0]:.6f}, "
              f"gap {g:.3e} ({g / lum[b][0]:.2%}), 5 SE {bound:.3e} (information only)",
              flush=True)

    # 7. checks and timing at the main path's shapes ------------------------
    # 1,104,000 lanes end in a partial block, so the kernels' tail masks run
    # here.  These launches come after the counters were read above.
    cols, rows = grid(MAIN_W, MAIN_H)
    settings = RenderSettings.make(samples_per_step=MAIN_SPS)
    kw = dict(width=MAIN_W, height=MAIN_H, max_path_length=10)
    seed = (5, 6)
    esc = trace.trace_sample(scene, settings, cols, rows, seed, **kw)
    err["trace"] = max(k1_err, trace_check(
        "K1 philox 1104x1000", esc,
        trace.trace_sample_plain(scene, settings, cols, rows, seed, **kw)))
    for name, m in (("env_shade", model), ("env_shade_int8", q8)):
        err[name] = max(err[name], shade_check(
            f"K2 {'int8 ' if is_int8(m) else ''}1104x1000 escapes", m, esc.esc_dir, esc.esc_w,
            settings.azimuth))
    for name, m in (("megastep", model), ("megastep_int8", q8)):
        err[name] = max(err[name], megastep_check(
            f"K3 {'int8 ' if is_int8(m) else ''}philox 1104x1000 {MAIN_SPS} samples",
            megastep.render_megastep(scene, settings, m, cols, rows, seed, **kw),
            megastep.render_megastep_plain(scene, settings, m, cols, rows, seed, **kw)))
    # One bake chunk at the default --max-nif-batch-size: rows 0..9 of the
    # 2048x4096 lattice, as models/envlight.bake_nif_env lays it out.
    bake_h, bake_w = meta.image_shape[:2]
    bake_u = (torch.arange(BAKE_ROWS, dtype=torch.float32, device=dev) / (bake_h - 1)
              ).repeat_interleave(bake_w)
    bake_v = torch.linspace(0.0, 1.0, bake_w, device=dev).repeat(BAKE_ROWS)
    for name, m in (("nif_apply", model), ("nif_apply_int8", q8)):
        err[name] = max(err[name], apply_check(
            f"K4 {'int8 ' if is_int8(m) else ''}bake chunk {BAKE_ROWS}x{bake_w}", m, bake_u,
            bake_v))
    times = {}

    def turns(name, kernel, plain, k_reps, p_reps, k_per=1, unit="full-frame sample"):
        """plain, kernel, kernel, plain: the two versions in turns, one card;
        ms per unit (a kernel launch may render k_per)."""
        a = cuda_ms(plain, p_reps)
        b = cuda_ms(kernel, k_reps)
        c = cuda_ms(kernel, k_reps)
        e = cuda_ms(plain, p_reps)
        times[name] = ((b + c) / 2 / k_per, (a + e) / 2)
        print(f"[timing] {name}: kernel {times[name][0]:.3f} ms, plain "
              f"{times[name][1]:.3f} ms per {unit}", flush=True)

    turns("trace",
          lambda: trace.trace_sample(scene, settings, cols, rows, seed, **kw),
          lambda: trace.trace_sample_plain(scene, settings, cols, rows, seed, **kw), 10, 2)
    one = settings._replace(samples_per_step=1)
    for m, suffix in ((model, ""), (q8, "_int8")):
        turns(f"env_shade{suffix}",
              lambda: nif.nif_env_shade(m, esc.esc_dir, esc.esc_w, settings.azimuth),
              lambda: nif.nif_env_shade_plain(m, esc.esc_dir, esc.esc_w, settings.azimuth),
              10, 2)
        turns(f"megastep{suffix}",  # kernel: 8-sample launches, as the main path; plain: 1
              lambda: megastep.render_megastep(scene, settings, m, cols, rows, seed, **kw),
              lambda: megastep.render_megastep_plain(scene, one, m, cols, rows, seed, **kw),
              3, 2, k_per=MAIN_SPS)
        turns(f"nif_apply{suffix}",
              lambda: nif.nif_apply_t(m, bake_u, bake_v),
              lambda: nif.nif_apply_t_plain(m, bake_u, bake_v), 50, 4,
              unit=f"bake chunk of {BAKE_ROWS * bake_w} points")
    for name in ("megastep", "megastep_int8"):
        print(f"[timing] {name} fused step device rate: "
              f"{MAIN_W * MAIN_H / times[name][0] / 1e3:.1f} Mpaths/s (information only)")

    k2 = "ipu_path_trace_tpu/ops/nif_pallas.py:432"
    k3 = "ipu_path_trace_tpu/ops/megastep_pallas.py:433"
    k4 = "ipu_path_trace_tpu/ops/nif_pallas.py:349"
    k5 = "ipu_path_trace_tpu/ops/nif_pallas.py:257"  # the int8 chain inside K2, K3 and K4
    rows_out = [
        ("trace", "csrc/trace.cu", "ipu_path_trace_tpu/ops/trace_pallas.py:549",
         launches["main unfused"]["trace"]),
        ("env_shade", "csrc/nif.cu", k2, launches["main unfused"]["env_shade"]),
        ("env_shade_int8", "csrc/nif.cu", k5, launches["main int8 unfused"]["env_shade"]),
        ("megastep", "csrc/megastep.cu", k3, launches["main fused"]["megastep"]),
        ("megastep_int8", "csrc/megastep.cu", k5, launches["main int8 fused"]["megastep"]),
        ("nif_apply", "csrc/nif.cu", k4, launches["main baked"]["nif_apply"]),
        ("nif_apply_int8", "csrc/nif.cu", k5, launches["main baked int8"]["nif_apply"]),
    ]
    report = {"kernels": [
        {"name": n, "route": "cuda", "source": f"ipu_path_trace_tpu_torch/{src}", "replaces": rep,
         "launches": nl, "max_abs_err": err[n], "ms": times[n][0], "plain_ms": times[n][1]}
        for n, src, rep, nl in rows_out]}
    if failures:
        raise SystemExit(f"chip_smoke: failed phases: {failures}")
    (out_dir / "report.json").write_text(json.dumps(
        {**report, "nvidia_smi": smi, "build_seconds": build_s, "ptxas": ptxas,
         "main_launches": launches, "main_luminance": lum}, indent=1))
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
