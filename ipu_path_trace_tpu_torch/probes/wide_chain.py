"""Hidden widths up to 384 in the ``wgmma`` chains: K2, K3 and K4 on a
6x384 net against their plain versions, and K3's time beside 320.

    python3 -m ipu_path_trace_tpu_torch.probes.wide_chain   # one CUDA GPU

A hidden layer of six 64-wide chunks (321-384 outputs) runs in two passes
of three chunks in the bf16 and int8 chains (csrc/nif_wgmma.cuh
``wg_hidden_passes``; the tf32 chain's two warpgroups take three chunks
each).  On a 6x384 net from ``models/nif.make_synthetic_nif`` (seeded;
the int8 twin quantised on the default lattice, the f32 one the same
weights in f32): K3 bf16, int8 and tf32 at a ragged 65,317 lanes (the last
CUDA block's rays end mid-tile) with budgets 0/1/8 and the statistics;
K2 and K4 bf16, int8 and tf32 at a ragged 65,573 lanes.
Each is held to the port's budgets: int8 bit for bit; bf16 the NIF budget
(median 5e-3, max 8e-2; K3 with the chain's rounding tail: at most one
lane in 10^4 past 8e-2, none past 0.25, and the flipped path lengths
under 5e-3); tf32 the reference's f32 rule (max 1.5e-2).  The same checks
on the 6x320 synthetic net from the same seed are the control: a failure
at 384 alone is the passes', not the net's.

Then the times (CUDA events): K3 per 1104x1000 sample in 8-sample
launches - the canonical asset (6x320), the synthetic 6x320 and 6x384,
bf16 and int8 - and, for the synthetic 6x320 and 6x384 in bf16, K2 on one
sample's escapes of that frame and K4 per bake chunk (10 rows of 4096);
at 6x384 also the plain versions of K3 (bf16 and int8), K2 and K4 on the
card (``*_plain``), and the cuBLAS bf16 chain (probes/tf32_chain.py
``library_chain``, a yardstick the port never calls) at the frame's rays
and at a bake chunk.  ``run`` returns the checks and times; chip_smoke.py
calls it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.nif import chain_name
from .tf32_chain import _escapes, rel_err

ROOT = Path(__file__).resolve().parents[2]
ASSET = ROOT / "assets" / "urban_alley_synth_nif"
WIDTH, HEIGHT, SAMPLES, MAX_PATH = 1104, 1000, 8, 10
RAGGED_N = 65_536 + 37  # K2 and K4: a ragged last tile
RAGGED_K3 = 255 * 256 + 37  # K3: the last CUDA block's rays end mid-tile
BAKE_ROWS, BAKE_W, BAKE_H = 10, 4096, 2048  # one bake chunk of the 2048x4096 lattice
NET_SEED = 384
SEED = (9, 10)
NIF_MEDIAN, NIF_MAX = 5e-3, 8e-2  # the reference's bf16 NIF budget
NIF_TAIL_FRACTION, NIF_TAIL_MAX = 1e-4, 0.25  # the bf16 chain's rounding tail in K3
F32_MAX = 1.5e-2  # the reference's f32 budget (tests/test_nif_pallas.py)
FLIP_FRACTION = 5e-3


def compare(name: str, chain: str, got: torch.Tensor, ref: torch.Tensor,
            flipped: torch.Tensor | None = None, tail: bool = False) -> dict:
    """One check: ``got`` (C, n) against ``ref`` on the lanes whose path
    lengths agree, under the chain's budget."""
    keep = slice(None) if flipped is None else ~flipped
    a, b = got[:, keep].float(), ref[:, keep].float()
    rel = rel_err(a, b)
    med, mx = float(rel.median()), float(rel.max())
    above = float((rel > NIF_MAX).any(dim=0).float().mean())
    frac = 0.0 if flipped is None else float(flipped.float().mean())
    finite = bool(torch.isfinite(got).all())
    if chain == "int8":
        ok = torch.equal(got, ref) and frac == 0.0
    elif chain == "tf32":
        ok = mx < F32_MAX and frac < FLIP_FRACTION
    elif tail:
        ok = med < NIF_MEDIAN and above <= NIF_TAIL_FRACTION and mx < NIF_TAIL_MAX \
            and frac < FLIP_FRACTION
    else:
        ok = med < NIF_MEDIAN and mx < NIF_MAX
    return {"name": name, "ok": ok and finite, "median_rel": med, "max_rel": mx,
            "lanes_above_8e2": above, "flipped_fraction": frac,
            "max_abs_err": float((a - b).abs().max())}


def nets(width: int, dev: torch.device) -> list:
    """The synthetic 6 x ``width`` net in bf16, int8 (lattice-calibrated
    PTQ) and f32, from NET_SEED."""
    from ..models.nif import make_params, make_synthetic_nif
    from ..models.quant import quantize_nif

    weights, meta = make_synthetic_nif(NET_SEED, hidden=width)
    return [make_params(weights, meta, torch.bfloat16, dev),
            quantize_nif(weights, meta, device=dev), make_params(weights, meta, torch.float32, dev)]


def grid(scene, dev: torch.device):
    """The main path's 1104x1000 worklist (coherent order) as f32 (cols, rows)."""
    from ..core.records import to_device_batch
    from ..runtime.worklist import coherent_order, create_tracing_jobs

    wl = coherent_order(create_tracing_jobs(WIDTH, HEIGHT), scene, WIDTH, HEIGHT, 90.0)
    work = to_device_batch(wl, dev)
    return work.u.float(), work.v.float()


def checks(dev: torch.device) -> list[dict]:
    """K2, K3 and K4 in the three chains on each synthetic net against
    their plain versions (module docstring)."""
    from ..core.scene import default_scene
    from ..ops import megastep, nif
    from ..render.params import RenderSettings

    gen = np.random.default_rng(2027)
    scene = default_scene(dev)
    cols, rows = grid(scene, dev)
    n = RAGGED_K3
    c3, r3 = cols[:n].contiguous(), rows[:n].contiguous()
    budgets = torch.from_numpy(gen.choice([0, 1, 8], -(-n // megastep.BUDGET_BLOCK))
                               .astype(np.int32)).to(dev)
    settings = RenderSettings.make(samples_per_step=SAMPLES)
    kw = dict(width=WIDTH, height=HEIGHT, max_path_length=MAX_PATH, budgets=budgets,
              with_stats=True)
    esc_dir, esc_w = _escapes(gen, RAGGED_N, dev)
    u, v = torch.from_numpy(gen.uniform(0.0, 1.0, (2, RAGGED_N)).astype(np.float32)).to(dev)
    out = []
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 and int8 chains in f32
    try:
        for width in (384, 320):  # 320: the control
            for m in nets(width, dev):
                ch = chain_name(m)
                tag = f"{ch} 6x{width}"
                out.append(compare(
                    f"K2 {tag} ragged {RAGGED_N}", ch,
                    nif.nif_env_shade(m, esc_dir, esc_w, 0.7).stack(),
                    nif.nif_env_shade_plain(m, esc_dir, esc_w, 0.7).stack()))
                out.append(compare(f"K4 {tag} ragged {RAGGED_N}", ch, nif.nif_apply_t(m, u, v),
                                   nif.nif_apply_t_plain(m, u, v)))
                got = megastep.render_megastep(scene, settings, m, c3, r3, SEED, **kw)
                ref = megastep.render_megastep_plain(scene, settings, m, c3, r3, SEED, **kw)
                flipped = got.path_len != ref.path_len
                name = f"K3 {tag} ragged {n} budgets 0/1/8+stats"
                row = compare(name, ch, got.radiance.stack(), ref.radiance.stack(), flipped,
                              tail=True)
                lum = compare(name, ch, got.lum2.sqrt()[None], ref.lum2.sqrt()[None], flipped,
                              tail=True)
                row["ok"] = row["ok"] and lum["ok"]
                row["lum2_max_rel"] = lum["max_rel"]
                out.append(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return out


def times(dev: torch.device) -> dict:
    """K3 ms per 1104x1000 sample (8-sample launches): the canonical
    asset, then the synthetic 6x320 and 6x384, bf16 and int8; K2 ms on a
    sample's escapes and K4 ms per bake chunk of the synthetic nets in bf16;
    at 6x384 the plain versions and the cuBLAS chain (module docstring)."""
    from ..core.scene import default_scene
    from ..models.nif import load_nif_assets
    from ..ops import megastep, nif, trace
    from ..render.params import RenderSettings
    from ..utils.devtime import time_per_call

    scene = default_scene(dev)
    cols, rows = grid(scene, dev)
    settings = RenderSettings.make(samples_per_step=SAMPLES)
    kw = dict(width=WIDTH, height=HEIGHT, max_path_length=MAX_PATH)
    models = {"canonical_bf16": load_nif_assets(str(ASSET), torch.bfloat16, dev)[0]}
    for width in (320, 384):
        bf16, int8, _ = nets(width, dev)
        models[f"synthetic{width}_bf16"] = bf16
        models[f"synthetic{width}_int8"] = int8
    out = {f"megastep_{k}": time_per_call(
        lambda m=m: megastep.render_megastep(scene, settings, m, cols, rows, SEED, **kw),
        5, dev) * 1e3 / SAMPLES for k, m in models.items()}
    st = trace.trace_sample(scene, settings, cols, rows, SEED, sample_index=0, **kw)
    bake_u = (torch.arange(BAKE_ROWS, dtype=torch.float32, device=dev) / (BAKE_H - 1)
              ).repeat_interleave(BAKE_W)
    bake_v = torch.linspace(0.0, 1.0, BAKE_W, device=dev).repeat(BAKE_ROWS)
    for width in (320, 384):
        m = models[f"synthetic{width}_bf16"]
        out[f"env_shade_synthetic{width}_bf16"] = time_per_call(
            lambda: nif.nif_env_shade(m, st.esc_dir, st.esc_w, settings.azimuth), 10, dev) * 1e3
        out[f"nif_apply_synthetic{width}_bf16"] = time_per_call(
            lambda: nif.nif_apply_t(m, bake_u, bake_v), 50, dev) * 1e3
    # 6x384: the plain versions (TF32 off: the plain int8 dots are f32
    # matmuls of integer values) and the cuBLAS bf16 chain.
    from .tf32_chain import library_chain

    m = models["synthetic384_bf16"]
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for chain in ("bf16", "int8"):
            mc = models[f"synthetic384_{chain}"]
            out[f"megastep_synthetic384_{chain}_plain"] = time_per_call(
                lambda: megastep.render_megastep_plain(scene, settings, mc, cols, rows, SEED,
                                                       **kw), 1, dev) * 1e3 / SAMPLES
        out["env_shade_synthetic384_bf16_plain"] = time_per_call(
            lambda: nif.nif_env_shade_plain(m, st.esc_dir, st.esc_w, settings.azimuth), 2,
            dev) * 1e3
        out["nif_apply_synthetic384_bf16_plain"] = time_per_call(
            lambda: nif.nif_apply_t_plain(m, bake_u, bake_v), 5, dev) * 1e3
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    for tag, npts in (("frame", cols.shape[0]), ("bake_chunk", bake_u.shape[0])):
        feats = torch.rand((npts, 4 * m.embedding_dim), device=dev).to(torch.bfloat16)
        out[f"cublas_chain_synthetic384_{tag}"] = time_per_call(
            lambda: library_chain(m, feats), 10, dev) * 1e3
    return out


def run(dev: torch.device) -> dict:
    return {"checks": checks(dev), "times_ms": times(dev)}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wide_chain: CUDA is not available; this probe runs on a GPU")
    from ..utils.devtime import card_line

    dev = torch.device("cuda", 0)
    res = run(dev)
    for c in res["checks"]:
        fields = " ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in c.items() if k not in ("name", "ok"))
        print(f"[{c['name']}] {'PASS' if c['ok'] else 'FAIL'} {fields}", flush=True)
    for k, v in res["times_ms"].items():
        print(f"[timing] {k}: {v:.4f} ms per sample", flush=True)
    print(card_line(dev), flush=True)
    print(json.dumps(res))
    return 0 if all(c["ok"] for c in res["checks"]) else 1


if __name__ == "__main__":
    sys.exit(main())
