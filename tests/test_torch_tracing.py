"""The port's tracing (utils/tracing.py) and the spans the loop, the step,
the controller and the mesh open on it, on the CPU; K3's per-block
records on the card.

On the CPU: spans are counted and their profiler ranges nest in the
trace, two threads' spans under a profiler that records every thread are
all counted; nothing is traced while no profiler records; the
module-level ``span`` does nothing without a current channel; a launch's
record from synthetic stamps (waves, slots, fill, tail, the shares);
each span opens its ``<channel>/<span>`` range in the exported profiler
trace; the ``--metrics-file``
summary counts the samples rendered and carries the spans; the
benchmark's ``record_budgets`` wrapper still sees the controller once a
step; the mesh's shard and reduction spans.

On the card (marked ``card``; it skips without CUDA):

    python -m pytest --noconftest tests/test_torch_tracing.py -m card -s

K3 with and without the record buffer gives bit-identical outputs, every
block writes its record, each launch's stamp span is within 2% of the
kernel's CUPTI duration, and ptxas reports no spills for the bf16 Philox
kernel, untraced and recording (their registers and spills are
printed).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from ipu_path_trace_tpu_torch.runtime.app import PathTracerApp
from ipu_path_trace_tpu_torch.runtime.config import Config
from ipu_path_trace_tpu_torch.utils import tracing
from ipu_path_trace_tpu_torch.utils.tracing import STAMP_WORDS, TraceChannel, launch_record

NIF = "assets/urban_alley_synth_nif"
BASE = dict(assets="constant:0.8,0.7,0.6", width=16, height=12, samples=8, samples_per_step=2,
            save_interval=100, seed=5, max_path_length=3, device="cpu", device_film=True,
            checkpoint="")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _run(tmp_path, max_steps=None, stop_after=None, **kw) -> PathTracerApp:
    app = PathTracerApp(Config(**{**BASE, "outfile": str(tmp_path / "x.png"), **kw}))
    app.init()
    app.build()
    if stop_after is not None:  # as a stop request after that step (runtime/cli.py)
        app._stop = lambda done: done >= stop_after
    app.execute(max_steps=max_steps)
    return app


def _ranges(prof, tmp_path, prefix="t/") -> list[dict]:
    """The profiler's user ranges named ``prefix...``, in time order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return sorted((e for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("cat") == "user_annotation" and e["name"].startswith(prefix)),
                  key=lambda e: (e["ts"], -e["dur"]))  # an outer range first


def test_spans_nest_in_the_profiler_trace(tmp_path):
    """Each step's spans are counted, and their profiler ranges nest: an
    inner one inside its outer one in time, the next span after both."""
    chan = TraceChannel("t")
    with _profile() as prof, chan.loop():
        for step in (1, 2):
            chan.step = step
            with tracing.span("outer"):
                with tracing.span("inner"):
                    pass
            with chan.span("after"):
                pass
    assert {k: v["count"] for k, v in chan.report().items()} == {
        "outer": 2, "inner": 2, "after": 2}
    ranges = _ranges(prof, tmp_path)
    assert [e["name"] for e in ranges] == ["t/outer", "t/inner", "t/after"] * 2
    end = [e["ts"] + e["dur"] for e in ranges]  # us, to the trace's ns (1e-3 us)
    for k in (0, 3):  # outer, inner, after
        assert ranges[k]["ts"] <= ranges[k + 1]["ts"] and end[k + 1] <= end[k] + 1e-3
        assert end[k] <= ranges[k + 2]["ts"] + 1e-3


def test_spans_from_two_threads_are_counted():
    """Under a profiler that records every thread (the app's
    --profile-dir), the main loop's and the host task's spans are all
    counted, none over another."""
    from torch._C._profiler import _ExperimentalConfig

    chan, n = TraceChannel("t"), 2000

    def spans(name):
        for _ in range(n):
            with chan.span(name):
                pass

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  experimental_config=_ExperimentalConfig(
                                      profile_all_threads=True))
    with prof, chan.loop():
        host = threading.Thread(target=spans, args=("host",))
        host.start()
        spans("main")
        host.join()
    report = chan.report()
    assert report["main"]["count"] == report["host"]["count"] == n
    assert report["main"]["total_s"] >= 0 and report["host"]["total_s"] >= 0


def test_nothing_kept_without_a_profiler():
    """Without a profiler tracing is off: a loop keeps no K3 record buffer
    and leaves the last traced loop's records, and its spans are counted."""
    before = tracing.launch_records()
    chan = TraceChannel("t")
    with chan.loop():
        assert tracing.tracing_on() is False
        with tracing.span("a"):
            pass
        assert chan._pending == []
    assert tracing.launch_records() == before
    assert chan.report()["a"]["count"] == 1


def test_module_span_is_a_noop_without_a_channel():
    with tracing.span("nobody"):
        pass
    assert tracing.tracing_on() is False
    outer, inner = TraceChannel("o"), TraceChannel("i")
    with outer.loop():
        with inner.loop():
            with tracing.span("x"):
                pass
        with tracing.span("y"):
            pass
    with tracing.span("z"):
        pass
    assert set(inner.report()) == {"x"} and set(outer.report()) == {"y"}


def _stamps(starts, ends, lanes=256 * 8, esc=1900, passes=16):
    s = np.zeros((len(starts), STAMP_WORDS), np.int64)
    s[:, 0], s[:, 1], s[:, 2] = starts, ends, np.arange(len(starts)) % 132
    s[:, 3], s[:, 4], s[:, 5] = lanes, esc, passes
    return s


def test_launch_record_waves_and_fill():
    """1,080 equal blocks on 132 SMs: 8.18 waves run as 9."""
    d = 1_000_000  # ns a block
    k = np.arange(1080)
    rec = launch_record(_stamps(1 + (k // 132) * d, 1 + (k // 132 + 1) * d), step=3, launch=0)
    assert (rec.blocks, rec.written, rec.slots, rec.step) == (1080, 1080, 132, 3)
    assert rec.waves == pytest.approx(1080 / 132) and round(rec.waves, 2) == 8.18
    assert rec.span == pytest.approx(9 * d * 1e-9) and rec.busy == pytest.approx(1080 * d * 1e-9)
    assert rec.fill == pytest.approx((1080 / 132) / 9)
    assert rec.tail == pytest.approx(d * 1e-9)


def test_launch_record_tail_shares_and_unwritten():
    """A block that starts last sets the tail; the shares; a block with
    no record is counted apart."""
    starts = np.array([10, 10, 20, 30, 0])
    ends = np.array([20, 30, 30, 90, 0])
    rec = launch_record(_stamps(starts, ends), tile_rays=128)
    assert (rec.blocks, rec.written, rec.slots) == (5, 4, 2)
    assert rec.tail == pytest.approx(60e-9) and rec.span == pytest.approx(80e-9)
    assert rec.busy == pytest.approx(100e-9) and rec.fill == pytest.approx(100 / (2 * 80))
    assert rec.lane_samples == 4 * 2048 and rec.escapes == 4 * 1900
    assert rec.escape_share == pytest.approx(1900 / 2048)
    assert rec.chain_useful_share == pytest.approx(1900 / (16 * 128))


def test_each_span_opens_its_profiler_range(tmp_path):
    """Each span opens one ``<channel>/<span>`` range in the profiler's
    trace, as long as the span (the loop opens no range of its own); the
    channel's seconds are the ranges' within 1 ms (a shared CPU)."""
    chan = TraceChannel("t")
    with _profile() as prof, chan.loop():
        for step in (1, 2, 3):
            chan.step = step
            with chan.span("ipu_render"):
                time.sleep(0.002 * step)
    ranges = _ranges(prof, tmp_path)
    assert [e["name"] for e in ranges] == ["t/ipu_render"] * 3
    for e, step in zip(ranges, (1, 2, 3)):
        assert e["dur"] * 1e-6 >= 0.002 * step
    total = chan.report()["ipu_render"]["total_s"]
    assert abs(sum(e["dur"] for e in ranges) * 1e-6 - total) < 1e-3


def test_summary_rate_counts_the_samples_rendered(tmp_path):
    """A loop stopped after one step of four: the summary's rate is that
    step's samples over the elapsed time, and it carries the spans."""
    mf = tmp_path / "m.jsonl"
    _run(tmp_path, stop_after=1, metrics_file=str(mf))
    summary = json.loads(mf.read_text().splitlines()[-1])
    assert summary["event"] == "summary" and summary["total_spp"] == 8
    rendered = 16 * 12 * 2
    elapsed = summary["elapsed_seconds"]
    assert summary["samples_per_sec"] == pytest.approx(rendered / elapsed, rel=0.05, abs=2)
    spans = summary["spans"]
    for name in ("ui_input", "ipu_render", "device_sync", "step_end", "final_fetch"):
        assert spans[name]["count"] == 1, name
    assert spans["wait_for_host"]["count"] == 2  # after the step, and on the way out


def test_record_budgets_sees_the_controller_once_a_step(tmp_path):
    """The benchmark's wrapper around render/adaptive.compute_budgets
    (port_bench/run.py) still sees one call a step inside the span."""
    from ipu_path_trace_tpu_torch.render import adaptive
    from port_bench.run import record_budgets

    with record_budgets(adaptive) as calls:
        app = _run(tmp_path, max_steps=2, assets=NIF, adaptive=True, adaptive_min=1,
                   env_skip="off")
    assert len(calls) == 2 and app.trace.report()["compute_budgets"]["count"] == 2
    assert adaptive.compute_budgets.__name__ == "compute_budgets"  # restored


def test_mesh_spans(tmp_path):
    """The sharded step's spans on a 2x2 CPU mesh: each pixel shard's
    launches and, with a sample axis, each shard's reduction."""
    app = _run(tmp_path, max_steps=1, ipus=4, mesh_shape="2x2")
    report = app.trace.report()
    assert report["shard_launch/0"]["count"] == report["shard_launch/1"]["count"] == 1
    assert report["film_reduction"]["count"] == 2


@pytest.mark.card
def test_k3_records_on_the_card(cuda):
    """Full-frame K3 launches (plain and adaptive with statistics), traced
    and untraced: bit-identical outputs, a record from every block, each
    launch's stamp span within 2% of its CUPTI duration, no spills."""
    import re

    from ipu_path_trace_tpu_torch.core.scene import default_scene
    from ipu_path_trace_tpu_torch.ops import _lib
    from ipu_path_trace_tpu_torch.ops.megastep import BUDGET_BLOCK, render_megastep
    from ipu_path_trace_tpu_torch.render.params import RenderSettings
    from ipu_path_trace_tpu_torch.runtime.app import parse_env_assets

    w, h, spp = 1104, 1000, 8
    env, _ = parse_env_assets(NIF, cuda)
    scene = default_scene(cuda)
    px = torch.arange(w * h, device=cuda)
    cols, rows = (px % w).float(), (px // w).float()
    groups = -(-(w * h) // BUDGET_BLOCK)
    budgets = torch.randint(1, 3 * spp, (groups,), generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32).to(cuda)
    kw = dict(width=w, height=h, max_path_length=10)
    calls = [dict(), dict(budgets=budgets, with_stats=True)]

    def launch(args):
        return render_megastep(scene, RenderSettings.make(samples_per_step=spp), env.model,
                               cols, rows, (7, 9), **kw, **args)

    for args in calls:  # build and warm
        launch(args)
    torch.cuda.synchronize()
    untraced = [launch(args) for args in calls]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, TraceChannel("t").loop():
        traced = [launch(args) for args in calls]
        torch.cuda.synchronize()
    for a, b in zip(untraced, traced):
        for x, y in ((a.radiance.stack(), b.radiance.stack()), (a.path_len, b.path_len),
                     (a.lum2, b.lum2)):
            if x is not None:
                assert torch.equal(x, y)
    recs = tracing.launch_records()
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and "megastep_wg_kernel" in e.name), key=lambda e: e.time_range.start)
    assert len(recs) == len(kernels) == 2
    for rec, k in zip(recs, kernels):
        cupti_s = (k.time_range.end - k.time_range.start) * 1e-6
        print(f"launch {rec.launch}: blocks {rec.blocks} slots {rec.slots} waves {rec.waves:.3f} "
              f"fill {rec.fill:.4f} tail {rec.tail * 1e3:.3f} ms span {rec.span * 1e3:.3f} ms "
              f"CUPTI {cupti_s * 1e3:.3f} ms escape share {rec.escape_share:.5f} chain useful "
              f"{rec.chain_useful_share:.5f}")
        assert rec.written == rec.blocks == -(-(w * h) // 256)
        assert abs(rec.span - cupti_s) <= 0.02 * cupti_s
        assert 0 < rec.escapes <= rec.lane_samples
    log = _lib.library_path().with_suffix(".log").read_text().splitlines()
    for record in (0, 1):  # the untraced kernel, and the recording one
        entry = rf"Compiling entry function '_ZN2pt18megastep_wg_kernelILi0ELi0ELi2ELb{record}EE"
        at = [i for i, ln in enumerate(log) if re.search(entry, ln)]
        assert at, f"no ptxas lines for megastep_wg_kernel<0,0,2,{record}> in the build log"
        lines = [ln.strip() for ln in log[at[0] + 1:at[0] + 4]
                 if "registers" in ln or "spill" in ln or "stack" in ln]
        print(f"ptxas megastep_wg_kernel<0,0,2,{record}>:", " | ".join(lines))
        assert lines and all(int(b) == 0 for ln in lines
                             for b in re.findall(r"(\d+) bytes spill", ln))
