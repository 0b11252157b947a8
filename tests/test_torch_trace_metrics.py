"""The benchmark's readers of the program's spans and K3 records
(port_bench/metrics/): k3_sm_fill_pct, k3_chain_useful_pct,
launch_idle_ms_per_step, loop_idle_ms_per_step and
controller_host_ms_per_step, on a synthetic profiler trace and synthetic
launch records (held to the trace's K3 kernels), and None where a parent
commit's run leaves them nothing to read.

The trace: three 100-ms steps 10 ms apart on two cards.  Each step's
kernel starts 4 ms (card 0) or 6 ms (card 1) into the step and ends 1 ms
before it; the step's device_sync starts 10 ms in; the controller's span
takes 2 ms.  So 5 ms of launch idle a step, and two 10-ms gaps between
the steps over 3 steps.
"""

import importlib

import numpy as np
import pytest

from ipu_path_trace_tpu_torch.utils import tracing
from port_bench.devtrace import DeviceTrace
from port_bench.run import LayerContext

READERS = ("k3_sm_fill_pct", "k3_chain_useful_pct", "launch_idle_ms_per_step",
           "loop_idle_ms_per_step", "controller_host_ms_per_step")
STEPS, CARDS = 3, 2
STEP_US, GAP_US = 100_000, 10_000


def _reader(name):
    return importlib.import_module(f"port_bench.metrics.{name}")


def _range(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _trace(new_spans=True) -> DeviceTrace:
    ev = [_range("port_bench/window", 0, 10_000_000)]
    for k in range(STEPS):
        t0 = 1_000 + k * (STEP_US + GAP_US)
        ev.append(_range("tpu_path_tracer/ipu_render", t0, STEP_US))
        if new_spans:
            ev.append(_range("tpu_path_tracer/compute_budgets", t0 + 1_000, 2_000))
            ev.append(_range("tpu_path_tracer/device_sync", t0 + 10_000, STEP_US - 10_000))
        for d in range(CARDS):
            start = t0 + 4_000 + 2_000 * d
            ev.append({"ph": "X", "cat": "kernel", "name": "void pt::megastep_wg_kernel<0>()",
                       "ts": start, "dur": t0 + STEP_US - 1_000 - start, "args": {"device": d}})
    return DeviceTrace({"traceEvents": ev})


def _ctx(trace, steps=STEPS, cards=CARDS) -> LayerContext:
    return LayerContext(trace, {}, {"adaptive": True}, steps, 0, 0, 0.32, cards)


def _records(count, stretch=1.0):
    """``count`` launches of 1,080 blocks on 132 slots, 1,900 of 2,048
    lane-samples escaping a block and 16 tile passes of 128 rays; each
    launch's span is its kernel's in ``_trace`` (95 ms on card 0, 93 ms
    on card 1) times ``stretch``."""
    k = np.arange(1080)
    out = []
    for i in range(count):
        card = i % CARDS
        block_ns = int(stretch * (95 - 2 * card) * 1e6 / 9)  # nine waves
        stamps = np.zeros((1080, tracing.STAMP_WORDS), np.int64)
        stamps[:, 0], stamps[:, 1] = 1 + (k // 132) * block_ns, 1 + (k // 132 + 1) * block_ns
        stamps[:, 3], stamps[:, 4], stamps[:, 5] = 2048, 1900, 16
        out.append(tracing.launch_record(stamps, device=card, step=1 + i // CARDS))
    return out


def test_idle_and_controller_readers():
    ctx = _ctx(_trace())
    assert _reader("launch_idle_ms_per_step").read(ctx) == pytest.approx(5.0)
    assert _reader("loop_idle_ms_per_step").read(ctx) == pytest.approx(2 * 10.0 / STEPS)
    assert _reader("controller_host_ms_per_step").read(ctx) == pytest.approx(2.0)


def test_k3_readers_read_the_program_records(monkeypatch):
    monkeypatch.setattr(tracing, "_launches", _records(STEPS * CARDS))
    ctx = _ctx(_trace())
    assert _reader("k3_sm_fill_pct").read(ctx) == pytest.approx(100 * (1080 / 132) / 9)
    assert _reader("k3_chain_useful_pct").read(ctx) == pytest.approx(100 * 1900 / (16 * 128))


@pytest.mark.parametrize("stretch", [0.97, 1.03])
def test_k3_readers_hold_the_records_to_the_device_trace(monkeypatch, stretch):
    """Records whose spans miss their kernels' CUPTI durations by more
    than 2% (a kernel that stamps itself wrong) are not read."""
    ctx = _ctx(_trace())
    monkeypatch.setattr(tracing, "_launches", _records(STEPS * CARDS, stretch=stretch))
    assert _reader("k3_sm_fill_pct").read(ctx) is None
    assert _reader("k3_chain_useful_pct").read(ctx) is None
    monkeypatch.setattr(tracing, "_launches", _records(STEPS * CARDS, stretch=1.01))
    assert _reader("k3_sm_fill_pct").read(ctx) == pytest.approx(100 * (1080 / 132) / 9)


@pytest.mark.parametrize("name", READERS)
def test_readers_without_their_spans_or_records(monkeypatch, name):
    """A parent commit's run: no new spans, no records (or no reader of
    them), or records that do not cover every step on every card.  The
    loop reader needs only the step ranges, which the parent has too."""
    ctx = _ctx(_trace(new_spans=False))
    monkeypatch.setattr(tracing, "_launches", [])
    if name == "loop_idle_ms_per_step":
        assert _reader(name).read(ctx) == pytest.approx(2 * 10.0 / STEPS)
        return
    assert _reader(name).read(ctx) is None
    if name.startswith("k3_"):
        monkeypatch.setattr(tracing, "_launches", _records(STEPS * CARDS - 1))
        assert _reader(name).read(ctx) is None
        monkeypatch.delattr(tracing, "launch_records")
        assert _reader(name).read(ctx) is None
