"""The f32 NIF chain on TF32 wgmma - K2, K3 and K4 under ``--partials-type
float`` - against its plain f32 version, beside the bf16 kernels.

    python3 -m ipu_path_trace_tpu_torch.probes.tf32_chain   # one CUDA GPU

On the canonical asset (``assets/urban_alley_synth_nif``) loaded in f32:
K2 on one Philox sample's escapes of the default scene at 1104x1000 and
on 65,573 numpy-seeded escapes (a ragged last tile); K4 on the 1104x1000
(u, v) lattice, one bake chunk of 10 rows of 4096 and 65,573 numpy-seeded
points; K3 at 1104x1000 (Philox, 8 samples) and at a ragged 65,317 lanes
with budgets 0/1/8 and the statistics.  Each kernel is held
to the reference's f32 rule against its plain f32 version (TF32 off in
PyTorch): rel = |out - ref| / (|ref| + 1e-2 max|ref|), max < 1.5e-2
(tests/test_nif_pallas.py); K3 also keeps its flipped-lane fraction
(path lengths that differ) under 5e-3 and is measured on the other lanes.
The bf16 kernel on the same inputs (the asset in bf16) is measured against
the same plain f32 chain; the tf32 route must be closer in median and in
max, or it would not be the reference's f32 mode.

Then each tf32 kernel is timed (CUDA events) beside its bf16 twin, its
plain f32 version and the library chain of the same products (cuBLAS f32
matmuls with relu and the skip concat, TF32 off and on; the port never
calls it).  ``run`` returns the checks and times; chip_smoke.py calls it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
ASSET = ROOT / "assets" / "urban_alley_synth_nif"
WIDTH, HEIGHT, SAMPLES, MAX_PATH = 1104, 1000, 8, 10
RAGGED_N = 65_536 + 37  # K2 and K4: a ragged last tile
RAGGED_K3 = 255 * 256 + 37  # K3: the last CUDA block's rays end mid-tile
BAKE_ROWS, BAKE_W, BAKE_H = 10, 4096, 2048
F32_MAX = 1.5e-2  # the reference's f32 budget (tests/test_nif_pallas.py:40-45)
FLIP_FRACTION = 5e-3
SEED = (7, 8)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The reference's relative error, floored at 1% of the peak."""
    return (got - ref).abs() / (ref.abs() + 1e-2 * ref.abs().max())


def _stats(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    rel = rel_err(got.float(), ref.float())
    return float(rel.median()), float(rel.max())


def _check(name: str, tf32, bf16, ref, flipped=None) -> dict:
    """One row: the tf32 kernel's median and max against the plain f32
    chain, the bf16 kernel's beside them, on the lanes that did not flip."""
    keep = slice(None) if flipped is None else ~flipped
    t_med, t_max = _stats(tf32[:, keep], ref[:, keep])
    b_med, b_max = _stats(bf16[:, keep], ref[:, keep])
    frac = 0.0 if flipped is None else float(flipped.float().mean())
    finite = bool(torch.isfinite(tf32).all())
    ok = (finite and t_max < F32_MAX and frac < FLIP_FRACTION and t_med < b_med
          and t_max < b_max)
    return {"name": name, "ok": ok, "tf32_median": t_med, "tf32_max": t_max,
            "bf16_median": b_med, "bf16_max": b_max, "flipped_fraction": frac,
            "max_abs_err": float((tf32[:, keep] - ref[:, keep]).abs().max())}


def _escapes(gen: np.random.Generator, n: int, dev):
    from ..core.vecmath import Vec3

    d = gen.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    escaped = gen.uniform(size=n) < 0.8
    d[:, ~escaped] = 0.0
    w = gen.uniform(0.0, 2.0, (3, n)).astype(np.float32)
    w[:, ~escaped] = 0.0
    return (Vec3.unstack(torch.from_numpy(d).to(dev)), Vec3.unstack(torch.from_numpy(w).to(dev)))


def library_chain(model, feats: torch.Tensor) -> torch.Tensor:
    """The NIF's products as cuBLAS matmuls in the features' dtype with
    relu and the skip concat between them: a yardstick for the chain
    kernels, never called by the port."""
    x = feats
    last = model.num_layers - 1
    for i, w in enumerate(model.kernels):
        if x.shape[-1] != w.shape[0]:
            x = torch.cat([x, feats], dim=-1)
        x = x @ w
        if i != last:
            x = torch.relu(x)
    return x


def run(dev: torch.device) -> dict:
    """The checks and times above on ``dev``; the launches of the tf32
    kernels are counted by the wrappers as ever."""
    from ..core.scene import default_scene
    from ..models.nif import load_nif_assets
    from ..ops import megastep, nif, trace
    from ..render.params import RenderSettings
    from ..runtime.worklist import coherent_order, create_tracing_jobs
    from ..utils.devtime import time_per_call

    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 chain in f32
    try:
        f32 = load_nif_assets(str(ASSET), torch.float32, dev)[0]
        bf16 = load_nif_assets(str(ASSET), torch.bfloat16, dev)[0]
        scene = default_scene(dev)
        gen = np.random.default_rng(2026)
        settings = RenderSettings.make(samples_per_step=SAMPLES)
        kw = dict(width=WIDTH, height=HEIGHT, max_path_length=MAX_PATH)

        def grid(on):
            from ..core.records import to_device_batch

            wl = coherent_order(create_tracing_jobs(WIDTH, HEIGHT), on, WIDTH, HEIGHT, 90.0)
            work = to_device_batch(wl, dev)
            return work.u.float(), work.v.float()

        cols, rows = grid(scene)
        checks = []
        # K2: a sample's escapes at the full frame, then numpy-seeded ones.
        st = trace.trace_sample(scene, settings, cols, rows, SEED, sample_index=0, **kw)
        ragged_dir, ragged_w = _escapes(gen, RAGGED_N, dev)
        for tag, d, w in ((f"{WIDTH}x{HEIGHT} escapes", st.esc_dir, st.esc_w),
                          (f"ragged {RAGGED_N}", ragged_dir, ragged_w)):
            checks.append(_check(
                f"K2 tf32 {tag}", nif.nif_env_shade(f32, d, w, settings.azimuth).stack(),
                nif.nif_env_shade(bf16, d, w, settings.azimuth).stack(),
                nif.nif_env_shade_plain(f32, d, w, settings.azimuth).stack()))
        # K4: the full-frame lattice, a bake chunk, numpy-seeded points.
        lat_u = (torch.arange(HEIGHT, dtype=torch.float32, device=dev) / HEIGHT
                 ).repeat_interleave(WIDTH)
        lat_v = (torch.arange(WIDTH, dtype=torch.float32, device=dev) / WIDTH).repeat(HEIGHT)
        bake_u = (torch.arange(BAKE_ROWS, dtype=torch.float32, device=dev) / (BAKE_H - 1)
                  ).repeat_interleave(BAKE_W)
        bake_v = torch.linspace(0.0, 1.0, BAKE_W, device=dev).repeat(BAKE_ROWS)
        ru, rv = torch.from_numpy(gen.uniform(0.0, 1.0, (2, RAGGED_N)).astype(np.float32)).to(dev)
        for tag, u, v in ((f"{WIDTH}x{HEIGHT} lattice", lat_u, lat_v),
                          (f"bake chunk {BAKE_ROWS}x{BAKE_W}", bake_u, bake_v),
                          (f"ragged {RAGGED_N}", ru, rv)):
            checks.append(_check(f"K4 tf32 {tag}", nif.nif_apply_t(f32, u, v),
                                 nif.nif_apply_t(bf16, u, v), nif.nif_apply_t_plain(f32, u, v)))
        # K3: the full frame, Philox; then ragged with budgets 0/1/8 and the
        # statistics.
        n = RAGGED_K3
        budgets = torch.from_numpy(gen.choice([0, 1, 8], -(-n // megastep.BUDGET_BLOCK))
                                   .astype(np.int32)).to(dev)
        ragged = dict(budgets=budgets, with_stats=True)
        for tag, c, r, extra in ((f"philox {WIDTH}x{HEIGHT} {SAMPLES} samples", cols, rows, {}),
                                 (f"ragged {n} budgets 0/1/8+stats",
                                  cols[:n].contiguous(), rows[:n].contiguous(), ragged)):
            got, twin, ref = (megastep.render_megastep(scene, settings, m, c, r, SEED, **extra,
                                                       **kw)
                              if m is not None else
                              megastep.render_megastep_plain(scene, settings, f32, c, r, SEED,
                                                             **extra, **kw)
                              for m in (f32, bf16, None))
            flipped = got.path_len != ref.path_len
            row = _check(f"K3 tf32 {tag}", got.radiance.stack(), twin.radiance.stack(),
                         ref.radiance.stack(), flipped)
            if ref.lum2 is not None:
                lum = _check(f"K3 tf32 {tag} sqrt(lum2)", got.lum2.sqrt()[None],
                             twin.lum2.sqrt()[None], ref.lum2.sqrt()[None], flipped)
                row["ok"] = row["ok"] and lum["ok"]
                row["lum2_tf32_max"], row["lum2_bf16_max"] = lum["tf32_max"], lum["bf16_max"]
            checks.append(row)

        # Times per unit of the main path: a 1104x1000 sample (K2, K3), a
        # bake chunk (K4); the library chains on the f32 and bf16 weights.
        def ms(fn, reps=3):
            return time_per_call(fn, reps, dev) * 1e3

        one = settings._replace(samples_per_step=1)
        times = {
            "env_shade_tf32": ms(lambda: nif.nif_env_shade(f32, st.esc_dir, st.esc_w,
                                                           settings.azimuth), 10),
            "env_shade_bf16": ms(lambda: nif.nif_env_shade(bf16, st.esc_dir, st.esc_w,
                                                           settings.azimuth), 10),
            "env_shade_tf32_plain": ms(lambda: nif.nif_env_shade_plain(
                f32, st.esc_dir, st.esc_w, settings.azimuth), 2),
            "megastep_tf32": ms(lambda: megastep.render_megastep(scene, settings, f32, cols,
                                                                 rows, SEED, **kw)) / SAMPLES,
            "megastep_bf16": ms(lambda: megastep.render_megastep(scene, settings, bf16, cols,
                                                                 rows, SEED, **kw)) / SAMPLES,
            "megastep_tf32_plain": ms(lambda: megastep.render_megastep_plain(
                scene, one, f32, cols, rows, SEED, **kw), 2),
            "nif_apply_tf32": ms(lambda: nif.nif_apply_t(f32, bake_u, bake_v), 50),
            "nif_apply_bf16": ms(lambda: nif.nif_apply_t(bf16, bake_u, bake_v), 50),
            "nif_apply_tf32_plain": ms(lambda: nif.nif_apply_t_plain(f32, bake_u, bake_v), 4),
        }
        for tag, npts in (("frame", cols.shape[0]), ("bake_chunk", bake_u.shape[0])):
            feats = torch.rand((npts, 4 * f32.embedding_dim), device=dev)
            for allow in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = allow
                times[f"cublas_f32_{'tf32_on' if allow else 'tf32_off'}_{tag}"] = ms(
                    lambda: library_chain(f32, feats), 10)
            torch.backends.cuda.matmul.allow_tf32 = False
            times[f"cublas_bf16_{tag}"] = ms(
                lambda: library_chain(bf16, feats.to(torch.bfloat16)), 10)
        escapes = sum(int(trace.trace_sample(scene, settings, cols, rows, SEED, sample_index=s,
                                             **kw).escaped.sum()) for s in range(SAMPLES))
        return {"checks": checks, "times_ms": times, "escapes_per_sample": escapes / SAMPLES,
                "rays": cols.shape[0], "bake_chunk": bake_u.shape[0]}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tf32_chain: CUDA is not available; this probe runs on a GPU")
    from ..utils.devtime import card_line

    dev = torch.device("cuda", 0)
    res = run(dev)
    for c in res["checks"]:
        fields = " ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in c.items() if k not in ("name", "ok"))
        print(f"[{c['name']}] {'PASS' if c['ok'] else 'FAIL'} {fields}", flush=True)
    for k, v in res["times_ms"].items():
        print(f"[timing] {k}: {v:.4f} ms", flush=True)
    print(card_line(dev), flush=True)
    print(json.dumps(res))
    return 0 if all(c["ok"] for c in res["checks"]) else 1


if __name__ == "__main__":
    sys.exit(main())
