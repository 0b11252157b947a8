"""One tiny CPU run of each study (plain versions): each writes under
--out only a JSON whose keys are the JAX record's (docs/*.json, read
only) - the top level and the curves' and rows' - with finite numbers.
The card runs them at full size (chip_smoke.py phase 12 at cut sizes)."""

import json
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
DOCS = ROOT / "docs"
TINY = ["--device", "cpu", "--width", "8", "--height", "8"]


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs files side by side in workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(module, args, tmp_path, name):
    import importlib

    mod = importlib.import_module(f"ipu_path_trace_tpu_torch.probes.{module}")
    assert mod.main(["--out", str(tmp_path)] + args) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [name]
    return json.loads((tmp_path / name).read_text())


def _record(name):
    return json.loads((DOCS / name).read_text())


def test_adaptive_bench_cpu(tmp_path):
    got = _run("adaptive_bench", TINY + ["--gt-spp", "4", "--spp-step", "2",
                                         "--check-steps", "1,2"], tmp_path,
               "adaptive_bench.json")
    want = _record("ADAPTIVE.json")
    assert set(want) - {"depth_check", "knob_sweep", "warm_cap_check"} <= set(got)
    for curve in ("uniform", "adaptive"):
        assert [p["total_spp"] for p in got[curve]] == [2, 4]
        assert set(want[curve][0]) <= set(got[curve][0])
        assert np.isfinite([p["rmse"] for p in got[curve]]).all()
    assert set(got["final_budgets"]) == set(want["final_budgets"])
    assert set(got["final_counts"]) == set(want["final_counts"])
    assert len(got["sample_efficiency"]) == 2 and got["sample_efficiency"][0] == 1.0
    assert got["device"] == "cpu, plain versions" and got["uniform"][0]["device_seconds"] is None


def test_sobol_bench_cpu(tmp_path):
    got = _run("sobol_bench", TINY + ["--gt-spp", "4", "--spp-step", "2", "--check-steps", "1",
                                      "--rate-spp", "1", "--rate-steps", "1",
                                      "--check-size", "8x8", "--check-spp", "4"], tmp_path,
               "sobol_bench.json")
    want = _record("SOBOL.json")
    assert set(want) <= set(got)
    assert set(got["curves"]) == set(want["curves"])
    assert set(got["sample_efficiency_vs_prng_uniform"]) == \
        set(want["sample_efficiency_vs_prng_uniform"])
    assert set(got["rates_mpaths_300spp"]) == set(want["rates_mpaths_300spp"])
    assert got["rate_spp"] == 1 and got["hw_vs_host_consistency"]["pass"]
    assert got["sample_efficiency_vs_prng_uniform"]["prng_adaptive"] == [1.0]


def test_denoise_bench_cpu(tmp_path):
    got = _run("denoise_bench", TINY + ["--gt-spp", "4", "--preview-spp", "1,2"], tmp_path,
               "denoise_bench.json")
    want = _record("DENOISE.json")
    assert set(want) <= set(got) and set(got["scenes"]) == set(want["scenes"])
    for name, scene in want["scenes"].items():
        mine = got["scenes"][name]
        assert set(scene) <= set(mine)
        assert [p["spp"] for p in mine["raw"]] == [1, 2]
        need = set(scene["denoised"][0]) - {"sample_multiplier_lower_bound"}
        for e in mine["denoised"]:
            assert need <= set(e)
            assert np.isfinite([v for k, v in e.items() if "rmse" in k]).all()


def test_adaptive_depth_check_cpu(tmp_path):
    got = _run("adaptive_depth_check", TINY + ["--n", "4", "--spp-step", "2", "--speedup", "2"],
               tmp_path, "adaptive_depth_check.json")
    want = _record("ADAPTIVE.json")["depth_check"]
    assert set(want) <= set(got["depth_check"])
    dc = got["depth_check"]
    assert (dc["uniform_spp"], dc["adaptive_spp"]) == (4, 2) and isinstance(dc["holds"], bool)


def test_adaptive_knob_sweep_cpu(tmp_path):
    from ipu_path_trace_tpu_torch.probes.adaptive_knob_sweep import KNOBS

    got = _run("adaptive_knob_sweep", TINY + ["--gt-spp", "2", "--spp-step", "1",
                                              "--steps", "1"], tmp_path,
               "adaptive_knob_sweep.json")
    want = _record("ADAPTIVE.json")["knob_sweep"]
    assert set(want) <= set(got["knob_sweep"])
    rows = got["knob_sweep"]["rows"]
    assert [(r["min"], r["max_factor"]) for r in rows] == KNOBS
    assert set(want["rows"][0]) <= set(rows[0])


def test_envskip_bench_stats_cpu(tmp_path):
    got = _run("envskip_bench", TINY + ["--samples", "1", "--stats-only"], tmp_path,
               "envskip_bench.json")
    want = _record("ENVSKIP.json")
    assert set(want) <= set(got) and set(got["scenes"]) == set(want["scenes"])
    assert got["block"] == 2048 and got["chain_tile"] == 128
    enclosed = got["scenes"]["enclosed"]
    assert enclosed["escape_fraction"] == 0.0 and enclosed["dead_block_fraction"] == 1.0
    assert enclosed["dead_block_fraction_chain_tile"] == 1.0
    assert got["scenes"]["default"]["escape_fraction"] > 0.5
