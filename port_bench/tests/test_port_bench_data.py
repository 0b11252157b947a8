"""BENCHMARK.json and the files it names: every cell's configuration,
traffic, limits and per-layer readers exist and keep the naming rules;
each per-layer metric moves an end-to-end metric its cells report; the
operation counts match a hand count; the device-trace readers read a
synthetic trace; and a run on the CPU at a tiny size ends in the result
line (with CUDA absent the command itself exits 2 and prints nothing)."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from port_bench import counts, run  # noqa: E402
from port_bench.cells import app_config, load_cell, load_json  # noqa: E402
from port_bench.devtrace import DeviceTrace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in DOC["workloads"]]


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["command"] == ["python3", "port_bench/run.py"]
    assert DOC["paths"] == ["port_bench"]
    assert 1 <= DOC["run_seconds"] <= 51
    names = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in DOC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for c in DOC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for w in DOC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_names_existing_files(cell):
    w = next(w for w in DOC["workloads"] if w["name"] == cell)
    config = next(c for c in DOC["configs"] if c["name"] == w["config"])
    assert (ROOT / config["file"]).is_file()
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    c = load_cell(cell)
    assert c.chips in (1, 4) and int(c.traffic["ipus"]) <= c.chips
    assert (ROOT / c.config["asset"]).is_dir()
    for metric in c.per_layer:
        assert hasattr(_reader(metric["name"]), "read")
    # Every number the check compares has a limit.
    want = {"order_mismatch", "count_mismatch", "plen_mismatch", "rgb_rel_l1"}
    if c.traffic["adaptive"]:
        want |= {"budget_mismatch", "lum2_rel_l1"}
    assert set(c.limits) == want
    from ipu_path_trace_tpu_torch.runtime.config import Config

    Config(**app_config(c, 2**31 + 5, "/nonexistent", "cuda")).validate()


def _reader(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_each_layer_metric_moves_a_reported_end_to_end_metric():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e, m
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            reported = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in reported, (m["name"], cell)


def test_operation_counts_by_hand():
    alley = load_json(BENCH / "configs" / "alley320.json")
    # 6 x 320, E = 12 (48 features), the skip input (320 + 48) at layer 3, 3 outputs.
    assert counts.chain_macs(alley) == 48 * 320 + 320 * 320 * 4 + 368 * 320 + 320 * 3 == 543680
    # Another chain, 6 x 192 with E = 16 (64 features): skip (192 + 64) at layer 3.
    narrow = {"layers": [[64, 192]] + [[192, 192]] * 2 + [[256, 192]] + [[192, 192]] * 2
              + [[192, 3]], "nif_precision": "int8"}
    assert counts.chain_macs(narrow) == 64 * 192 + 192 * 192 * 4 + 256 * 192 + 192 * 3 == 209472
    assert counts.weight_bytes(narrow) == 209472 + 6 * 192 + 3
    assert counts.nif_ops(alley, 1000) == pytest.approx(2 * 543680 * 1000 * alley["escape_share"])
    # One bf16 frame sample at 1104 x 1000 is about 1.14 ms of the card's peak.
    t, by = counts.k3_least_seconds(alley, {"adaptive": False}, 1104000, 1104000, 1)
    assert by == "ops" and t == pytest.approx(1.1434e-3, rel=1e-3)
    assert counts.weight_bytes(alley) == 2 * (543680 + 6 * 320 + 3)


def test_the_chains_precision_is_one_key():
    c = load_cell(CELLS[0])
    assert "chain" not in c.config and "partials_type" not in c.config
    kw = app_config(c, 2**31 + 5, "/nonexistent", "cuda")
    assert (kw["nif_precision"], kw["partials_type"]) == ("auto", "half")  # the app's bf16 chain
    int8 = c._replace(config={**c.config, "nif_precision": "int8"})
    assert app_config(int8, 1, "/nonexistent", "cuda")["nif_precision"] == "int8"
    with pytest.raises(ValueError, match="nif_precision"):
        app_config(c._replace(config={**c.config, "nif_precision": "fp16"}), 1, "/x", "cuda")
    # The reference has the bf16 chain (and the control's fp8) and refuses another.
    from port_bench.reference.nif import load_nif

    with pytest.raises(ValueError, match="precision"):
        load_nif(str(ROOT / c.config["asset"]), "int8")


def _synthetic_trace(steps=3, cards=1):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "port_bench/window", "ts": 0,
           "dur": 1000.0 * (steps + 1)}]
    for k in range(steps):
        t = 100.0 + 1000.0 * k
        ev.append({"ph": "X", "cat": "user_annotation", "name": "tpu_path_tracer/ipu_render",
                   "ts": t, "dur": 990.0})
        for d in range(cards):
            ev.append({"ph": "X", "cat": "kernel", "name": "void pt::megastep_wg_kernel<0>()",
                       "ts": t + 10, "dur": 800.0 + 40.0 * d, "args": {"device": d}})
            ev.append({"ph": "X", "cat": "kernel", "name": "add", "ts": t + 820 + 40 * d,
                       "dur": 10.0, "args": {"device": d}})
    return DeviceTrace({"traceEvents": ev})


def test_device_trace_and_readers():
    tr = _synthetic_trace(steps=3, cards=4)
    assert tr.steps == 3 and tr.window_s == pytest.approx(2.99e-3)
    assert tr.busy_s(0) == pytest.approx(3 * 810e-6)
    config = load_json(BENCH / "configs" / "alley320.json")
    traffic = {"adaptive": True, "samples_per_step": 1}
    ctx = run.LayerContext(tr, config, traffic, 3, 1000, 1000, 2.99e-3, 4)
    idle = _reader("device_idle_pct").read(ctx)
    busy = [810, 850, 890, 930]
    assert idle == pytest.approx(100 * (1 - sum(busy) * 3e-6 / 4 / 2.99e-3))
    skew = _reader("shard_skew_pct").read(ctx)
    assert skew == pytest.approx(100 * (920 / 860 - 1))
    assert _reader("budget_ms_per_step").read(ctx) == pytest.approx(1e3 * 4 * 10e-6)
    k3 = _reader("k3_roofline").read(ctx)
    least, _ = counts.k3_least_seconds(config, traffic, 1000, 1000, 12)
    assert k3 == pytest.approx(100 * least / (3 * (800 + 840 + 880 + 920) * 1e-6))
    gaps = tr.idle_gaps(3)  # the longest: card 0 between its steps
    assert gaps[0] == ["tpu_path_tracer/ipu_render", pytest.approx(180e-6)]
    assert tr.host_span_at(1.095e-3) == "after tpu_path_tracer/ipu_render"
    # Nothing to read: no megastep kernel, one card, a uniform step.
    empty = DeviceTrace({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": r.name, "ts": r.t0 * 1e6,
         "dur": (r.t1 - r.t0) * 1e6} for r in tr.ranges]})
    ctx1 = ctx._replace(trace=empty, cards=1, traffic={"adaptive": False})
    for name in ("k3_roofline", "shard_skew_pct", "budget_ms_per_step"):
        assert _reader(name).read(ctx1) is None


def cut(cell_name, **traffic):
    c = load_cell(cell_name)
    return c._replace(config={**c.config, "width": 24, "height": 16},
                      traffic={**c.traffic, "samples_per_step": 2, "adaptive_min": 1, **traffic})


def test_cpu_run_ends_in_the_result_line(capsys):
    result = run.run_cell(cut("alley320.batch300"), 2**31 + 77, 1.0, False, device="cpu")
    run.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:3] == ["correct", "attempted", "failed"] and list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"mpaths_per_s", "setup_s"}
    assert line["metrics"]["mpaths_per_s"]["unit"] == "Mpaths/s"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert err.strip().splitlines()[-1].startswith("check rgb_rel_l1:")


def test_without_cuda_the_command_exits_2_and_prints_nothing():
    done = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0], "--seed",
                           "2147483700", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == run.EXIT_NO_CARD and done.stdout == ""


def test_without_the_renderer_the_command_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0], "--seed",
                           "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and done.stdout == ""
