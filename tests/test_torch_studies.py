"""The studies' arithmetic against the JAX scripts' (probes/, tools/ of the port).

The scripts' own functions are imported without calling ``main`` (no
script writes ``docs/`` here): ``_mean_rgb`` (adaptive_bench.py,
sobol_bench.py), ``film_of`` and ``ldr_rmse`` (denoise_bench.py) and
``primary_hit_key`` (coherent_layout_probe.py), on the same numpy inputs
from a seed.  Where a script's logic is inline in its ``main`` (the
time-to-quality speedup, the equal-quality multiplier, the two-seed
identity), the port's function is checked on hand-made curves and on the
JAX records' own numbers (``docs/*.json``, read only).  Also the port's
``grid_scene`` and ``roulette_weight`` against the JAX package's, K3's
shared-memory plan at every object count of scene_scale_bench, and the
Sobol table generator.  The probes' tiny CPU runs are in
tests/test_torch_studies_run.py.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
DOCS = ROOT / "docs"


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs files side by side in workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"study_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(name):
    return json.loads((DOCS / name).read_text())


def _records(n, seed, width=None):
    """Numpy worklist sums of n records (the last 5 padding when width is
    given, else arbitrary), counts with zeros."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, width or 1000, n).astype(np.int32)
    v = rng.integers(0, 8, n).astype(np.int32)
    if width is not None:
        u[-5:] = v[-5:] = 0xFFFF
    rgb = [rng.gamma(1.5, 2.0, n).astype(np.float32) for _ in range(3)]
    cnt = rng.integers(0, 40, n).astype(np.int32)
    return u, v, rgb, cnt


@pytest.mark.parametrize("script", ["adaptive_bench", "sobol_bench"])
def test_mean_rgb_equals_the_script(script):
    from types import SimpleNamespace

    from ipu_path_trace_tpu_torch.core.records import WorkBatch
    from ipu_path_trace_tpu_torch.probes import _study

    mod = _script(script)
    u, v, (r, g, b), cnt = _records(300, 3, width=16)
    mask = u != 0xFFFF
    want = mod._mean_rgb(SimpleNamespace(r=r, g=g, b=b, sample_count=cnt), mask)
    t = torch.from_numpy
    got = _study.mean_rgb(WorkBatch(t(u), t(v), t(r), t(g), t(b), t(cnt), t(cnt)), mask)
    assert got.dtype == np.float64 and got.shape == (3, int(mask.sum()))
    np.testing.assert_array_equal(got, want)
    assert _study.rmse(got, want * 0.5) == float(np.sqrt(np.mean((got - want * 0.5) ** 2)))


def test_film_of_and_ldr_rmse_equal_the_script(monkeypatch):
    from ipu_path_trace_tpu.core.records import WorkBatch as JaxWork
    from ipu_path_trace_tpu_torch.core.records import WorkBatch
    from ipu_path_trace_tpu_torch.probes import denoise_bench

    mod = _script("denoise_bench")
    w, h = 24, 8
    monkeypatch.setattr(mod, "W", w)
    monkeypatch.setattr(mod, "H", h)
    u, v, (r, g, b), cnt = _records(w * h, 9)
    u = np.tile(np.arange(w, dtype=np.int32), h)
    v = np.repeat(np.arange(h, dtype=np.int32), w)
    want = mod.film_of(JaxWork(u, v, r, g, b, cnt, cnt))
    t = torch.from_numpy
    got = denoise_bench.film_of(WorkBatch(t(u), t(v), t(r), t(g), t(b), t(cnt), t(cnt)), w, h)
    np.testing.assert_array_equal(got, want)
    ref = np.random.default_rng(4).random((h, w, 3)).astype(np.float32)
    assert denoise_bench.ldr_rmse(got, ref) == pytest.approx(mod.ldr_rmse(want, ref), abs=1e-6)


def test_primary_hit_key_equals_the_script(monkeypatch):
    from ipu_path_trace_tpu.core.records import make_worklist as jax_worklist
    from ipu_path_trace_tpu.core.scene import default_scene as jax_scene
    from ipu_path_trace_tpu_torch.core.records import make_worklist
    from ipu_path_trace_tpu_torch.core.scene import default_scene
    from ipu_path_trace_tpu_torch.probes import coherent_layout_probe

    mod = _script("coherent_layout_probe")
    w, h = 40, 24
    monkeypatch.setattr(mod, "WIDTH", w)
    monkeypatch.setattr(mod, "HEIGHT", h)
    jwl = jax_worklist(w, h, padded_size=w * h + 7)
    wl = make_worklist(w, h, padded_size=w * h + 7)
    want = mod.primary_hit_key(jax_scene(), jwl["u"], jwl["v"], 90.0)
    got = coherent_layout_probe.primary_hit_key(default_scene(), wl["u"], wl["v"], 90.0, w, h)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) >= {-1, 0, 2}
    orders, frac = coherent_layout_probe.layouts(default_scene(), wl, w, h)
    assert sorted(orders) == ["coherent", "raster", "shuffled"]
    keys = coherent_layout_probe.primary_hit_key(default_scene(), orders["coherent"]["u"],
                                                 orders["coherent"]["v"], 90.0, w, h)
    assert (np.diff(keys) >= 0).all() and sum(frac.values()) == pytest.approx(1.0)


def test_time_to_quality_speedup_on_hand_curves():
    """adaptive_bench.py:150-157: n_match = n_u (rmse_u / rmse_a)^2, t_match
    = t_u n_match / n_u, speedup t_match / t_a."""
    from ipu_path_trace_tpu_torch.probes.adaptive_bench import time_to_quality_speedup

    uni = [{"total_spp": 128, "rmse": 0.3, "seconds": 1.0, "device_seconds": 0.5},
           {"total_spp": 2048, "rmse": 0.1, "seconds": 10.0, "device_seconds": 8.0}]
    ada = [{"total_spp": 128, "rmse": 0.3, "seconds": 1.2, "device_seconds": 0.6},
           {"total_spp": 2048, "rmse": 0.05, "seconds": 12.0, "device_seconds": 9.0}]
    assert time_to_quality_speedup(uni, ada) == round(40.0 / 12.0, 2)  # n_match 8192
    assert time_to_quality_speedup(uni, ada, "device_seconds") == round(32.0 / 9.0, 2)
    assert time_to_quality_speedup(uni, uni) == 1.0


def test_sample_efficiency_and_speedup_reproduce_the_records():
    """The port's arithmetic on the JAX records' own curves gives the
    records' ratios (ADAPTIVE.json, SOBOL.json)."""
    from ipu_path_trace_tpu_torch.probes import _study
    from ipu_path_trace_tpu_torch.probes.adaptive_bench import time_to_quality_speedup

    ad = _record("ADAPTIVE.json")
    assert _study.sample_efficiency(ad["uniform"], ad["adaptive"]) == ad["sample_efficiency"]
    assert time_to_quality_speedup(ad["uniform"], ad["adaptive"]) == \
        ad["time_to_quality_speedup"]
    sb = _record("SOBOL.json")
    for k, effs in sb["sample_efficiency_vs_prng_uniform"].items():
        assert _study.sample_efficiency(sb["curves"]["prng_uniform"], sb["curves"][k]) == effs
    assert _study.sample_efficiency([{"rmse": 0.3}, {"rmse": 0.2}],
                                    [{"rmse": 0.3}, {"rmse": 0.1}]) == [1.0, 4.0]


def test_equal_quality_bounds_on_hand_curves_and_the_record():
    """denoise_bench.py's bound: the deepest measured raw checkpoint the
    best sigma beats, over the checkpoint's spp; no entry when none."""
    from ipu_path_trace_tpu_torch.probes.denoise_bench import SIGMAS, equal_quality_bounds

    raw = [{"spp": s, "ldr_rmse": e} for s, e in ((8, 0.12), (32, 0.11), (128, 0.09),
                                                   (512, 0.07))]

    def entry(spp, best):
        return {"spp": spp, **{f"denoised_ldr_rmse_sigma{s}": best + i * 0.01
                               for i, s in enumerate(SIGMAS)}}

    dn = [entry(8, 0.10), entry(32, 0.06), entry(128, 0.2)]
    equal_quality_bounds(raw, dn, SIGMAS)
    assert [e["beats_measured_raw_spp"] for e in dn] == [32, 512, 0]
    assert [e.get("sample_multiplier_lower_bound") for e in dn] == [4.0, 16.0, None]
    rec = _record("DENOISE.json")
    for scene in rec["scenes"].values():
        want = scene["denoised"]
        got = [{k: v for k, v in e.items() if k not in ("beats_measured_raw_spp",
                                                         "sample_multiplier_lower_bound")}
               for e in want]
        equal_quality_bounds(scene["raw"], got, rec["sigmas"])
        assert got == want


def test_two_seed_identity():
    """adaptive_depth_check.py: noise_u^2 = uu^2 / 2, noise_a^2 = mean(au^2,
    ab^2) - noise_u^2 (>= 0), holds when sqrt(noise_a^2 / noise_u^2) <= 1;
    the JAX record's three RMSEs give its ratio and verdict."""
    from ipu_path_trace_tpu_torch.probes.adaptive_depth_check import two_seed_identity

    ratio, holds = two_seed_identity(np.sqrt(2.0), np.sqrt(1.64), np.sqrt(1.64))
    assert ratio == pytest.approx(0.8) and holds
    ratio, holds = two_seed_identity(np.sqrt(2.0), np.sqrt(2.44), np.sqrt(2.44))
    assert ratio == pytest.approx(1.2) and not holds
    assert two_seed_identity(1.0, 0.1, 0.1) == (0.0, True)
    dc = _record("ADAPTIVE.json")["depth_check"]
    ratio, holds = two_seed_identity(dc["rmse_uniA_uniB"], dc["rmse_ada_uniA"],
                                     dc["rmse_ada_uniB"])
    assert round(ratio, 3) == dc["noise_ratio_a_over_u"] and holds == dc["holds"]


@pytest.mark.parametrize("n", [5, 23, 95])
def test_grid_scene_equals_jax_bit_for_bit(n):
    from ipu_path_trace_tpu.core.scene import grid_scene as jax_grid
    from ipu_path_trace_tpu_torch.core.scene import grid_scene

    want, got = jax_grid(n), grid_scene(n)
    assert got.num_spheres == n and got.num_objects == n + 1
    for name, w, g in zip(got._fields, want, got):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    with pytest.raises(ValueError):
        grid_scene(0)


def test_roulette_weight_equals_jax():
    import jax.numpy as jnp

    from ipu_path_trace_tpu.core.materials import roulette_weight as jax_rr
    from ipu_path_trace_tpu_torch.core.materials import roulette_weight

    rand = np.random.default_rng(2).random(257).astype(np.float32)
    rand[:3] = (0.0, 0.1, 0.25)
    for p in (0.0, 0.1, 0.25, 0.5):
        s_want, w_want = jax_rr(jnp.asarray(rand), p)
        s_got, w_got = roulette_weight(torch.from_numpy(rand), p)
        np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_want))
        assert w_got == w_want
    s_want, w_want = jax_rr(jnp.asarray(rand), jnp.float32(0.3))
    s_got, w_got = roulette_weight(torch.from_numpy(rand), torch.tensor(0.3))
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_want))
    assert float(w_got) == float(w_want)


@pytest.mark.parametrize("net", ["nif_w192e16", "synthetic 6x384"])
def test_megastep_plan_at_every_swept_object_count(net):
    """K3's shared-memory plan (the chain's ring stages after the scene's
    tables) fits at every object count scene_scale_bench sweeps, on the
    bf16, int8 and tf32 chains, and on a 6x384 net."""
    from ipu_path_trace_tpu_torch.core.scene import grid_scene
    from ipu_path_trace_tpu_torch.models.nif import (load_nif_assets, make_params,
                                                     make_synthetic_nif)
    from ipu_path_trace_tpu_torch.models.quant import quantize_nif
    from ipu_path_trace_tpu_torch.ops.megastep import megastep_wg_plan, table_bytes
    from ipu_path_trace_tpu_torch.probes.scene_scale_bench import COUNTS

    if net.startswith("synthetic"):
        weights, meta = make_synthetic_nif(0, hidden=384)
    else:
        _, meta, weights = load_nif_assets(str(ROOT / "assets" / net), torch.float32)
    models = {"bf16": make_params(weights, meta, torch.bfloat16),
              "tf32": make_params(weights, meta, torch.float32),
              "int8": quantize_nif(weights, meta, device="cpu")}
    assert COUNTS == (6, 12, 24, 48, 96)
    for n in COUNTS:
        scene = grid_scene(n - 1)
        assert scene.num_objects == n
        assert table_bytes(scene) == 48 * (n - 1) + 60
        for chain, model in models.items():
            assert megastep_wg_plan(model, scene)["stages"] >= 2, (net, chain, n)


def test_gen_sobol_dirs_reproduces_the_table():
    from ipu_path_trace_tpu_torch.render import _sobol_dirs
    from ipu_path_trace_tpu_torch.tools import gen_sobol_dirs

    dirs = gen_sobol_dirs.directions()
    assert dirs == _sobol_dirs.DIRS and len(dirs) == 44 and {len(r) for r in dirs} == {32}
    src = pathlib.Path(_sobol_dirs.__file__).read_text()
    assert gen_sobol_dirs.module_text(dirs) == src


def test_ui_probe_step_seconds():
    from ipu_path_trace_tpu_torch.probes.ui_probe import slow_share, step_seconds

    log = ("[I] Completed render step 1/9 in 0.500 seconds (render+fetch 0.4, ...)\n"
           "[I] something else\n"
           "[I] Completed render step 2/9 in 0.100 seconds (render 0.09, ...)\n"
           "[I] Completed render step 3/9 in 0.120 seconds (render 0.09, ...)\n")
    secs = step_seconds(log)
    assert secs == [0.5, 0.1, 0.12]
    s = slow_share(secs)
    assert s["median_s"] == 0.12 and s["slow_share"] == pytest.approx(1 / 3)
    assert slow_share([])["slow_share"] is None


def test_no_study_imports_jax():
    """The port's studies import neither jax nor the JAX package nor scripts/."""
    names = ["_study", "adaptive_bench", "sobol_bench", "denoise_bench", "adaptive_depth_check",
             "adaptive_knob_sweep", "scene_scale_bench", "envskip_bench", "fused_bench",
             "phase_bench", "megastep_split", "host_roundtrip_bench", "coherent_layout_probe",
             "ui_probe"]
    files = [ROOT / "ipu_path_trace_tpu_torch" / "probes" / f"{n}.py" for n in names]
    files += [ROOT / "ipu_path_trace_tpu_torch" / "tools" / f"{n}.py" for n in (
        "adaptive_compare", "sobol_compare", "denoise_compare", "gen_sobol_dirs")]
    for f in files:
        text = f.read_text()
        for bad in ("import jax", "from jax", "ipu_path_trace_tpu.", "from scripts",
                    "import scripts"):
            assert bad not in text, (f.name, bad)
