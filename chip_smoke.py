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
  5b. modes   - K1 in Owen-Sobol mode (12 and 4 + 4L dims, bit for bit) and
                K3, bf16 and int8, in Sobol mode, with per-block budgets and
                the statistics (hardware and host noise), with the env-skip,
                and with all of them at once, vs their plain versions at
                256x256; and K3 with the env-skip on and off on the enclosed
                scene (nothing escapes), which must agree bit for bit;
  6. main     - the CLI (runtime/cli.main) at 1104x1000, 16 spp in steps of
                8: assets/urban_alley_synth_nif fused and unfused; the int8
                asset with --nif-precision int8 fused and unfused;
                --nif-mode baked (bf16, then int8); --device-film (saving
                every step, then only at the last); --device-film --adaptive;
                --sampler sobol fused and unfused; --env-skip on (the open
                default scene); --scene <enclosed> (--env-skip auto must
                resolve on; on the default scene off); and the int8 asset
                with --device-film --adaptive --sampler sobol.  Every
                kernel's launch counter is set to 0 just before each run and
                read just after (a fused run's auto env-skip probe launches
                K1 twice); the app's log (each step's, save's and bake's
                seconds) goes to stdout.  The device-film frames must equal
                the host film's, and fused and unfused frames agree in mean
                luminance within 5 standard errors;
  7. full frame - at the main path's shapes (1104x1000, a ragged last
                block): K1 (Philox), K2 (on that sample's escapes, bf16 and
                int8), K3 (Philox, 8 samples, bf16 and int8), K4 (one bake
                chunk of 10 rows of 4096, bf16 and int8) and phase 5b's
                modes vs their plain versions, then each kernel and its
                plain version timed (CUDA events, after warm-up), K3 with
                the env-skip on and off on both scenes (on the enclosed one
                the skip must take K3 under a quarter of its time), and the
                adaptive step against the uniform one.
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
    may take a neighbouring int8 code);
  * the new modes of K1 and K3 bit for bit, except K3's bf16 radiance and
    the square root of its lum2 (whose relative error is that of the
    samples' luminance): median 5e-3 and max 8e-2 on all but at most one
    lane in 10^4, and every lane below 0.25.  From 256x256 up, a lane of
    the bf16 chain passes 8e-2 about once in 10^5 in every RNG mode,
    Philox included: the error of one sample's env term sets its lane's
    (the trace parts agree bit for bit), and the worst lanes measured are
    0.124 (Sobol) and 0.125 (Philox), and 0.13 over the full bake lattice,
    so a max over a million lanes is a tail statistic.
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
# The bf16 chain's rounding tail: past 8e-2 on about one lane in 10^5, in
# every RNG mode (Philox included), at its worst 0.13 on one evaluation.
NIF_TAIL_FRACTION, NIF_TAIL_MAX = 1e-4, 0.25
INT8_MEDIAN, INT8_SHADE_FRACTION, INT8_SHADE_MAX = 1e-3, 1e-2, 0.5
BAKE_ROWS = 30 * 1472 // 4096  # rows per bake chunk at the default --max-nif-batch-size
SOBOL_DIMS = 12  # the CLI's default --sobol-dims
SOBOL_KEY = 0x5EED5EED
ADAPTIVE_MIN = 2  # below --samples-per-step 8, so the controller's budgets vary
# The camera inside an emissive diffuse shell: no path escapes, so every
# NIF sub-tile of K3 skips the chain (tests/test_megastep.py:129-135).
ENCLOSED_SCENE = {"objects": [
    {"type": "sphere", "center": [0.0, 0.0, 0.0], "radius": 50.0, "colour": [0.5, 0.5, 0.5],
     "material": "diffuse", "emission": [0.2, 0.2, 0.2]},
    {"type": "sphere", "center": [0.0, -0.5, -3.0], "radius": 0.5, "colour": [0.8, 0.3, 0.3],
     "material": "specular"},
]}

failures: list[str] = []


class LogLines(logging.Handler):
    """Keeps the app's log messages of the current CLI run."""

    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def env_skip_auto(self) -> str | None:
        """'on'/'off' as the auto env-skip probe resolved, None if none ran."""
        got = [ln.rsplit("-> ", 1)[1] for ln in self.lines if ln.startswith("--env-skip auto")]
        return got[-1] if got else None

    def seconds(self, prefix: str) -> list[float]:
        """The '... in <s> seconds' of each message that starts with prefix."""
        return [float(ln.split(" in ", 1)[1].split()[0]) for ln in self.lines
                if ln.startswith(prefix)]


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


def as_tensor(x) -> torch.Tensor:
    return x.stack() if hasattr(x, "stack") else x


def trace_exact(name, got, ref) -> float:
    """K1 against its plain version, every output bit for bit."""
    pairs = [(as_tensor(getattr(got, f)), as_tensor(getattr(ref, f))) for f in got._fields]
    err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    phase(name, all(torch.equal(a, b) for a, b in pairs), max_abs_err=f"{err:.3e}")
    return err


def mode_check(name, got, ref, int8: bool) -> float:
    """K3 in a new mode against its plain version: path lengths bit for
    bit; radiance and sqrt(lum2) bit for bit with the int8 chain, within
    the bf16 NIF budget, but for the chain's rounding tail, with the bf16
    chain."""
    pairs = [(got.radiance.stack(), ref.radiance.stack())]
    stats_ok = (got.lum2 is None) == (ref.lum2 is None)
    if ref.lum2 is not None and got.lum2 is not None:
        pairs.append((got.lum2.sqrt()[None], ref.lum2.sqrt()[None]))
    err = max(float((a - b).abs().max()) for a, b in pairs)
    finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs)
    med = mx = tail = 0.0
    for a, b in pairs:
        rel = rel_err(a, b)
        med, mx = max(med, float(rel.median())), max(mx, float(rel.max()))
        tail = max(tail, float((rel > NIF_MAX).any(dim=0).float().mean()))
    close = (all(torch.equal(a, b) for a, b in pairs) if int8
             else med < NIF_MEDIAN and tail <= NIF_TAIL_FRACTION and mx < NIF_TAIL_MAX)
    phase(name, stats_ok and finite and close and torch.equal(got.path_len, ref.path_len),
          path_len_equal=torch.equal(got.path_len, ref.path_len), median_rel=f"{med:.2e}",
          max_rel=f"{mx:.2e}", lanes_above_8e2=f"{tail:.2e}", max_abs_err=f"{err:.3e}",
          stats=ref.lum2 is not None)
    return err


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
    from ipu_path_trace_tpu_torch.core.scenefile import scene_from_dict
    from ipu_path_trace_tpu_torch.core.vecmath import Vec3
    from ipu_path_trace_tpu_torch.models.envlight import NifEnv
    from ipu_path_trace_tpu_torch.models.nif import load_nif_assets
    from ipu_path_trace_tpu_torch.models.quant import quantize_nif
    from ipu_path_trace_tpu_torch.ops import _lib, megastep, nif, trace
    from ipu_path_trace_tpu_torch.render.adaptive import (adaptive_caps, adaptive_render_step,
                                                          compute_budgets)
    from ipu_path_trace_tpu_torch.render.params import RenderSettings, StaticConfig
    from ipu_path_trace_tpu_torch.render.wavefront import render_step
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
    enclosed = scene_from_dict(ENCLOSED_SCENE, dev)
    gen = np.random.default_rng(2024)

    def grid(w, h, on=None):
        wl = coherent_order(create_tracing_jobs(w, h), on or scene, w, h, 90.0)
        work = to_device_batch(wl, dev)
        return work.u.float(), work.v.float()

    def sobol_ctx(cols, rows, width):
        """(pixel id, per-lane base from the numpy seed, key) of Sobol mode."""
        pid = rows.to(torch.int32) * width + cols.to(torch.int32)
        base = torch.from_numpy(gen.integers(0, 4096, cols.shape[0]).astype(np.int32)).to(dev)
        return pid, base, SOBOL_KEY

    def random_budgets(n, most):
        groups = -(-n // megastep.BUDGET_BLOCK)
        return torch.from_numpy(gen.integers(1, most + 1, groups).astype(np.int32)).to(dev)

    def mode_checks(tag, cols, rows, kw, settings, seed, noise):
        """Phase 5b's checks at one shape: K1 Sobol, then K3's modes with
        both chains (host noise covers the budgets), then env-skip on
        against off on the enclosed scene."""
        sob = sobol_ctx(cols, rows, kw["width"])
        for dims in (SOBOL_DIMS, 4 + 4 * kw["max_path_length"]):
            err["trace_sobol"] = max(err.get("trace_sobol", 0.0), trace_exact(
                f"K1 sobol {dims} dims {tag}",
                trace.trace_sample(scene, settings, cols, rows, seed, sample_index=3, sobol=sob,
                                   sobol_dims=dims, **kw),
                trace.trace_sample_plain(scene, settings, cols, rows, seed, sample_index=3,
                                         sobol=sob, sobol_dims=dims, **kw)))
        budgets = random_budgets(cols.shape[0], noise.shape[0])
        sobol = dict(sobol=sob, sobol_dims=SOBOL_DIMS)
        stats = dict(budgets=budgets, with_stats=True)
        modes = [("sobol", "sobol", dict(seed=seed, **sobol)),
                 ("budgets+stats", "budgets_stats", dict(seed=seed, **stats)),
                 ("budgets+stats host-noise", "budgets_stats", dict(noise=noise, **stats)),
                 ("env-skip", "env_skip", dict(seed=seed, env_skip=True)),
                 ("sobol+budgets+stats+env-skip", "sobol_budgets_stats",
                  dict(seed=seed, env_skip=True, **sobol, **stats))]
        ecols, erows = grid(kw["width"], kw["height"], enclosed)
        for m in (model, q8):
            int8 = is_int8(m)
            prefix, label8 = ("megastep_int8", "int8 ") if int8 else ("megastep", "")
            for label, key, args in modes:
                key = f"{prefix}_{key}"
                err[key] = max(err.get(key, 0.0), mode_check(
                    f"K3 {label8}{label} {tag}",
                    megastep.render_megastep(scene, settings, m, cols, rows, **args, **kw),
                    megastep.render_megastep_plain(scene, settings, m, cols, rows, **args, **kw),
                    int8))
            on, off = (megastep.render_megastep(enclosed, settings, m, ecols, erows, seed,
                                                env_skip=skip, with_stats=True, **kw)
                       for skip in (True, False))
            phase(f"K3 {label8}env-skip on = off, enclosed {tag}",
                  all(torch.equal(as_tensor(a), as_tensor(b)) for a, b in zip(on, off))
                  and float((on.radiance.stack() > 0.0).float().mean()) > 0.99)
            key = f"{prefix}_env_skip_enclosed"
            err[key] = max(err.get(key, 0.0), mode_check(
                f"K3 {label8}env-skip enclosed {tag}", on,
                megastep.render_megastep_plain(enclosed, settings, m, ecols, erows, seed,
                                               env_skip=True, with_stats=True, **kw),
                int8))

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

    # 5b. the Sobol, budget/statistics and env-skip modes -------------------
    mode_checks("256x256", cols, rows, kw, settings, (13, 14), noise3_t)

    # 6. main path through the CLI ------------------------------------------
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    enclosed_json = out_dir / "enclosed.json"
    enclosed_json.write_text(json.dumps(ENCLOSED_SCENE))
    counters = (trace.trace_sample, nif.nif_env_shade, megastep.render_megastep,
                nif.nif_apply_t)
    plains = (trace.trace_sample_plain, nif.nif_env_shade_plain,
              megastep.render_megastep_plain, nif.nif_apply_t_plain)
    steps = MAIN_SPP // MAIN_SPS
    bake_chunks = -(-meta.image_shape[0] // BAKE_ROWS)
    int8_flags = ["--nif-precision", "int8"]
    adaptive = ["--device-film", "--adaptive", "--adaptive-min", str(ADAPTIVE_MIN)]
    sobol_flags = ["--sampler", "sobol"]
    # A fused NIF run resolves the default --env-skip auto with a probe of
    # two K1 launches; the unfused and baked runs have no skip to resolve.
    probe = 2
    fused_want = [probe, 0, steps, 0]
    # (name, asset, flags, fused, launches of trace, env shade, megastep, nif
    # apply, what --env-skip auto resolves to: "on", "off" or None = no probe)
    runs = [
        ("main fused", ASSET, [], True, fused_want, "off"),
        ("main unfused", ASSET, [], False, [MAIN_SPP, MAIN_SPP, 0, 0], None),
        ("main int8 fused", INT8_ASSET, int8_flags, True, fused_want, "off"),
        ("main int8 unfused", INT8_ASSET, int8_flags, False, [MAIN_SPP, MAIN_SPP, 0, 0], None),
        ("main baked", ASSET, ["--nif-mode", "baked"], True, [MAIN_SPP, 0, 0, bake_chunks],
         None),
        ("main baked int8", INT8_ASSET, int8_flags + ["--nif-mode", "baked"], True,
         [MAIN_SPP, 0, 0, bake_chunks], None),
        ("device film", ASSET, ["--device-film"], True, fused_want, "off"),
        # Fetched and saved at the last step only: what the device film saves.
        ("device film save-interval 2", ASSET, ["--device-film", "--save-interval", "2"], True,
         fused_want, "off"),
        ("device film adaptive", ASSET, adaptive, True, fused_want, "off"),
        ("sobol fused", ASSET, sobol_flags, True, fused_want, "off"),
        ("sobol unfused", ASSET, sobol_flags, False, [MAIN_SPP, MAIN_SPP, 0, 0], None),
        ("env-skip on open scene", ASSET, ["--env-skip", "on"], True, [0, 0, steps, 0], None),
        ("enclosed scene", ASSET, ["--scene", str(enclosed_json)], True, fused_want, "on"),
        ("int8 device film adaptive sobol", INT8_ASSET, int8_flags + adaptive + sobol_flags,
         True, fused_want, "off"),
    ]
    lum, launches, frames, wall, step_s, save_s = {}, {}, {}, {}, {}, {}
    # The app's per-step, per-save and bake seconds, on stdout (cli.main's
    # own logging set-up then keeps this handler).
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="  app: %(asctime)s %(message)s")
    app_log = LogLines()
    logging.getLogger().addHandler(app_log)
    for name, asset, flags, fused, want, want_skip in runs:
        png = out_dir / f"{name.replace(' ', '_')}.png"
        argv = ["-w", str(MAIN_W), "-H", str(MAIN_H), "-s", str(MAIN_SPP),
                "--samples-per-step", str(MAIN_SPS), "--assets", str(ROOT / asset),
                "-o", str(png), *flags]
        app_log.lines.clear()
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
        frames[name] = hdr
        wall[name] = secs
        step_s[name] = app_log.seconds("Completed render step")
        save_s[name] = app_log.seconds("Saved images")
        skip = app_log.env_skip_auto()
        phase(name, rc == 0 and got == want and not any(plain_cuda) and skip == want_skip
              and bool(np.isfinite(hdr).all()) and hdr.shape == (MAIN_H, MAIN_W, 3),
              launches_trace_shade_megastep_apply=got, plain_runs_on_cuda=plain_cuda,
              env_skip_auto=skip, mean_luminance=f"{mean:.6f}", mc_se=f"{se:.2e}",
              mpaths_per_s_incl_setup=f"{MAIN_W * MAIN_H * MAIN_SPP / secs / 1e6:.2f}",
              wall_s=f"{secs:.2f}")

    def gap(a, b):
        return abs(lum[a][0] - lum[b][0]), 5.0 * math.hypot(lum[a][1], lum[b][1])

    for a, b in (("main fused", "main unfused"), ("main int8 fused", "main int8 unfused"),
                 ("sobol fused", "sobol unfused")):
        g, bound = gap(a, b)
        phase(f"{a} vs unfused", g <= bound, luminance_gap=f"{g:.3e}", bound_5se=f"{bound:.3e}")
    # Same seeds, same samples: the film rebuilt from the device's running
    # sums is the host film's step-wise sum, up to the order of f32 adds.
    for name in ("device film", "device film save-interval 2"):
        rel = float(np.max(np.abs(frames[name] - frames["main fused"])
                           / (np.abs(frames["main fused"]) + 1e-6)))
        phase(f"{name} = host film", rel < 1e-5, max_rel=f"{rel:.2e}")
    for a, b in (("main int8 fused", "main fused"), ("main baked", "main fused"),
                 ("main baked int8", "main int8 fused"), ("device film adaptive", "main fused"),
                 ("sobol fused", "main fused"),
                 ("int8 device film adaptive sobol", "main int8 fused")):
        g, bound = gap(a, b)
        print(f"[gap] {a} vs {b}: mean luminance {lum[a][0]:.6f} vs {lum[b][0]:.6f}, "
              f"gap {g:.3e} ({g / lum[b][0]:.2%}), 5 SE {bound:.3e} (information only)",
              flush=True)
    for name in ("main fused", "device film", "device film save-interval 2",
                 "device film adaptive"):
        print(f"[timing] film: {name}: wall {wall[name]:.3f} s, steps {step_s[name]} s, "
              f"saves {save_s[name]} s", flush=True)

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
    # Phase 5b's modes at the main path's shapes, host noise for 8 samples
    # made on the card.
    noise_gen = torch.Generator(device=dev).manual_seed(2025)
    noise8 = torch.rand((MAIN_SPS, 4 + 4 * kw["max_path_length"], cols.shape[0]),
                        generator=noise_gen, device=dev)
    noise8[:, 0:2] = torch.randn((MAIN_SPS, 2, cols.shape[0]), generator=noise_gen, device=dev)
    mode_checks("1104x1000", cols, rows, kw, settings, seed, noise8)
    del noise8
    times = {}

    def versus(a, b, a_reps, b_reps):
        """b, a, a, b: two versions in turns on one card; ms per call of each."""
        b1 = cuda_ms(b, b_reps)
        a1 = cuda_ms(a, a_reps)
        a2 = cuda_ms(a, a_reps)
        b2 = cuda_ms(b, b_reps)
        return (a1 + a2) / 2, (b1 + b2) / 2

    def turns(name, kernel, plain, k_reps, p_reps, k_per=1, unit="full-frame sample"):
        """The kernel and its plain version in turns; ms per unit (a kernel
        launch may render k_per)."""
        k, p = versus(kernel, plain, k_reps, p_reps)
        times[name] = (k / k_per, p)
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

    # The new modes.  Budgets of 8 for every block (the uniform step's
    # work) time the budget and statistics path itself; the plain version
    # renders one sample (budgets of 1).
    sob = sobol_ctx(cols, rows, MAIN_W)
    groups = -(-cols.shape[0] // megastep.BUDGET_BLOCK)
    eights = torch.full((groups,), MAIN_SPS, dtype=torch.int32, device=dev)
    ones = torch.ones_like(eights)
    sobol = dict(sobol=sob, sobol_dims=SOBOL_DIMS)
    turns("trace_sobol",
          lambda: trace.trace_sample(scene, settings, cols, rows, seed, **sobol, **kw),
          lambda: trace.trace_sample_plain(scene, settings, cols, rows, seed, **sobol, **kw),
          10, 2)
    ecols, erows = grid(MAIN_W, MAIN_H, enclosed)
    for name, m, sc, c, r, k_args, p_args in (
            ("megastep_sobol", model, scene, cols, rows, sobol, sobol),
            ("megastep_budgets_stats", model, scene, cols, rows,
             dict(budgets=eights, with_stats=True), dict(budgets=ones, with_stats=True)),
            ("megastep_env_skip", model, scene, cols, rows, dict(env_skip=True),
             dict(env_skip=True)),
            ("megastep_env_skip_enclosed", model, enclosed, ecols, erows, dict(env_skip=True),
             dict(env_skip=True)),
            ("megastep_int8_sobol_budgets_stats", q8, scene, cols, rows,
             dict(budgets=eights, with_stats=True, **sobol),
             dict(budgets=ones, with_stats=True, **sobol))):
        turns(name,
              lambda: megastep.render_megastep(sc, settings, m, c, r, seed, **k_args, **kw),
              lambda: megastep.render_megastep_plain(sc, one, m, c, r, seed, **p_args, **kw),
              3, 2, k_per=MAIN_SPS)
    # The env-skip guard: its cost where nearly every sub-tile escapes,
    # and its saving where none does (there K3 is the trace alone, so
    # 1 - on/off is the NIF chain's share of K3).
    guard = {}
    for tag, sc, c, r in (("open", scene, cols, rows), ("enclosed", enclosed, ecols, erows)):
        for m, suffix in ((model, ""), (q8, " int8")):
            on, off = versus(
                lambda: megastep.render_megastep(sc, settings, m, c, r, seed, env_skip=True, **kw),
                lambda: megastep.render_megastep(sc, settings, m, c, r, seed, **kw), 3, 3)
            guard[tag + suffix] = (on / MAIN_SPS, off / MAIN_SPS)
            print(f"[timing] K3{suffix} env-skip on vs off, {tag} scene: {on / MAIN_SPS:.3f} vs "
                  f"{off / MAIN_SPS:.3f} ms per full-frame sample ({on / off - 1:+.2%})",
                  flush=True)
    for suffix in ("", " int8"):
        on, off = guard["enclosed" + suffix]
        phase(f"K3{suffix} env-skip fires on the enclosed scene", on < 0.25 * off,
              on_ms=f"{on:.3f}", off_ms=f"{off:.3f}", chain_share=f"{1 - on / off:.2%}")
    # The adaptive step against the uniform one, from the state of one
    # cold (uniform) and one adaptive step of the device film.
    static = StaticConfig(width=MAIN_W, height=MAIN_H, max_path_length=kw["max_path_length"],
                          adaptive_min=ADAPTIVE_MIN)
    env = NifEnv(model)
    work = to_device_batch(
        coherent_order(create_tracing_jobs(MAIN_W, MAIN_H), scene, MAIN_W, MAIN_H, 90.0), dev)
    lum2 = torch.zeros(work.u.shape[0], dtype=torch.float32, device=dev)
    for s in range(2):
        work, lum2 = adaptive_render_step(scene, settings, static, work, lum2, (9, s), env)
    min_spp, cap = adaptive_caps(static, MAIN_SPS)
    budgets = compute_budgets(work.r, work.g, work.b, lum2, work.sample_count,
                              block_size=megastep.BUDGET_BLOCK, samples_per_step=MAIN_SPS,
                              min_spp=min_spp, max_spp=cap)
    ada, uni = versus(lambda: adaptive_render_step(scene, settings, static, work, lum2, seed, env),
                      lambda: render_step(scene, settings, static, work, seed, env), 3, 3)
    times["adaptive_step"] = (ada, uni)
    print(f"[timing] adaptive step {ada:.3f} ms vs uniform step {uni:.3f} ms ({ada / uni - 1:+.2%});"
          f" budgets min {int(budgets.min())} max {int(budgets.max())} (cap {cap}), total "
          f"{int(budgets.sum())} of {groups * MAIN_SPS}", flush=True)

    k1 = "ipu_path_trace_tpu/ops/trace_pallas.py:549"
    k2 = "ipu_path_trace_tpu/ops/nif_pallas.py:432"
    k3 = "ipu_path_trace_tpu/ops/megastep_pallas.py:433"
    k4 = "ipu_path_trace_tpu/ops/nif_pallas.py:349"
    k5 = "ipu_path_trace_tpu/ops/nif_pallas.py:257"  # the int8 chain inside K2, K3 and K4
    rows_out = [
        ("trace", "csrc/trace.cu", k1, launches["main unfused"]["trace"]),
        ("env_shade", "csrc/nif.cu", k2, launches["main unfused"]["env_shade"]),
        ("env_shade_int8", "csrc/nif.cu", k5, launches["main int8 unfused"]["env_shade"]),
        ("megastep", "csrc/megastep.cu", k3, launches["main fused"]["megastep"]),
        ("megastep_int8", "csrc/megastep.cu", k5, launches["main int8 fused"]["megastep"]),
        ("nif_apply", "csrc/nif.cu", k4, launches["main baked"]["nif_apply"]),
        ("nif_apply_int8", "csrc/nif.cu", k5, launches["main baked int8"]["nif_apply"]),
        # The modes of this slice, each with the launches of the CLI run
        # that drove it.
        ("trace_sobol", "csrc/trace.cu", k1, launches["sobol unfused"]["trace"]),
        ("megastep_sobol", "csrc/megastep.cu", k3, launches["sobol fused"]["megastep"]),
        ("megastep_budgets_stats", "csrc/megastep.cu", k3,
         launches["device film adaptive"]["megastep"]),
        ("megastep_env_skip", "csrc/megastep.cu", k3,
         launches["env-skip on open scene"]["megastep"]),
        ("megastep_env_skip_enclosed", "csrc/megastep.cu", k3,
         launches["enclosed scene"]["megastep"]),
        ("megastep_int8_sobol_budgets_stats", "csrc/megastep.cu", k5,
         launches["int8 device film adaptive sobol"]["megastep"]),
    ]
    report = {"kernels": [
        {"name": n, "route": "cuda", "source": f"ipu_path_trace_tpu_torch/{src}", "replaces": rep,
         "launches": nl, "max_abs_err": err[n], "ms": times[n][0], "plain_ms": times[n][1]}
        for n, src, rep, nl in rows_out]}
    if failures:
        raise SystemExit(f"chip_smoke: failed phases: {failures}")
    (out_dir / "report.json").write_text(json.dumps(
        {**report, "nvidia_smi": smi, "build_seconds": build_s, "ptxas": ptxas,
         "main_launches": launches, "main_luminance": lum, "main_wall_s": wall,
         "main_step_s": step_s, "main_save_s": save_s, "env_skip_on_off_ms": guard,
         "adaptive_vs_uniform_step_ms": times["adaptive_step"]}, indent=1))
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
