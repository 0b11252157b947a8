"""K3's trace counters in its per-block record (csrc/megastep.cuh): the
trace phase's time, the lane-iterations the warps held and the bounces
the lanes ran, reduced by utils/tracing.launch_record, and the
benchmark's two readers of them (port_bench/metrics/k3_trace_ms_per_step.py
and k3_trace_lane_useful_pct.py) on synthetic stamps and a synthetic
profiler trace, as tests/test_torch_trace_metrics.py builds them; None
where a parent commit's run leaves them nothing to read.

The launches: 1,080 blocks on 132 slots in nine waves, each block in
its trace phase for 30% of its run, its warps holding 8 x 32 x 640
lane-iterations of which 61,440 ran a bounce.
"""

import importlib
from collections import namedtuple

import numpy as np
import pytest

from ipu_path_trace_tpu_torch.utils import tracing
from port_bench.devtrace import DeviceTrace
from port_bench.run import LayerContext

READERS = ("k3_trace_ms_per_step", "k3_trace_lane_useful_pct")
# A parent commit's record: every field up to the chain's share, none of the trace's.
ParentRecord = namedtuple("ParentRecord", tracing.LaunchRecord._fields[
    :tracing.LaunchRecord._fields.index("chain_useful_share") + 1])
STEPS, CARDS = 3, 2
STEP_US = 100_000
BLOCKS, SLOTS = 1080, 132
TRACE_SHARE = 0.3
LANE_ITERS = 8 * 32 * 640  # eight warps, 640 of their most bounces summed over samples
BOUNCES = 61_440  # three lanes in eight busy, on average


def _reader(name):
    return importlib.import_module(f"port_bench.metrics.{name}")


def _trace() -> DeviceTrace:
    """Each step's K3 kernel on each card: 95 ms on card 0, 93 on card 1."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "port_bench/window", "ts": 0,
           "dur": 10_000_000}]
    for k in range(STEPS):
        t0 = 1_000 + k * (STEP_US + 10_000)
        ev.append({"ph": "X", "cat": "user_annotation", "name": "tpu_path_tracer/ipu_render",
                   "ts": t0, "dur": STEP_US})
        for d in range(CARDS):
            start = t0 + 4_000 + 2_000 * d
            ev.append({"ph": "X", "cat": "kernel", "name": "void pt::megastep_wg_kernel<0>()",
                       "ts": start, "dur": t0 + STEP_US - 1_000 - start, "args": {"device": d}})
    return DeviceTrace({"traceEvents": ev})


def _ctx() -> LayerContext:
    return LayerContext(_trace(), {}, {"adaptive": False}, STEPS, 0, 0, 0.33, CARDS)


def _stamps(block_ns: int) -> np.ndarray:
    k = np.arange(BLOCKS)
    s = np.zeros((BLOCKS, tracing.STAMP_WORDS), np.int64)
    s[:, 0], s[:, 1] = 1 + (k // SLOTS) * block_ns, 1 + (k // SLOTS + 1) * block_ns
    s[:, 3], s[:, 4], s[:, 5] = 2048, 600, 16
    s[:, 6] = int(TRACE_SHARE * block_ns)
    s[:, 7], s[:, 8] = LANE_ITERS, BOUNCES
    return s


def _records():
    out = []
    for i in range(STEPS * CARDS):
        card = i % CARDS
        block_ns = int((95 - 2 * card) * 1e6 / 9)  # nine waves fill the kernel
        out.append(tracing.launch_record(_stamps(block_ns), device=card, step=1 + i // CARDS))
    return out


def test_launch_record_sums_the_trace_words():
    rec = tracing.launch_record(_stamps(1_000_000))
    assert tracing.STAMP_WORDS == 9
    assert rec.trace_busy == pytest.approx(BLOCKS * TRACE_SHARE * 1e-3)
    assert rec.trace_busy / rec.busy == pytest.approx(TRACE_SHARE)
    assert (rec.trace_lane_iters, rec.trace_bounces) == (BLOCKS * LANE_ITERS, BLOCKS * BOUNCES)
    # The older words keep their meaning.
    assert (rec.lane_samples, rec.escapes, rec.tile_passes) == (BLOCKS * 2048, BLOCKS * 600,
                                                                BLOCKS * 16)
    # A block that wrote no record (start 0) adds nothing.
    s = _stamps(1_000_000)
    s[0, :2] = 0
    part = tracing.launch_record(s)
    assert part.written == BLOCKS - 1
    assert part.trace_bounces == (BLOCKS - 1) * BOUNCES


def test_launch_record_without_trace_work():
    s = _stamps(1_000_000)
    s[:, 6:] = 0
    rec = tracing.launch_record(s)
    assert (rec.trace_busy, rec.trace_lane_iters, rec.trace_bounces) == (0.0, 0, 0)


def test_readers_read_the_trace_counters(monkeypatch):
    monkeypatch.setattr(tracing, "_launches", _records())
    ctx = _ctx()
    # K3's span a step, mean of cards: (95 + 93) / 2 ms, 30% of it tracing.
    assert _reader("k3_trace_ms_per_step").read(ctx) == pytest.approx(TRACE_SHARE * 94.0,
                                                                      rel=1e-6)
    assert _reader("k3_trace_lane_useful_pct").read(ctx) == pytest.approx(
        100 * BOUNCES / LANE_ITERS)


@pytest.mark.parametrize("name", READERS)
def test_readers_without_the_trace_counters(monkeypatch, name):
    """A parent commit's run: records without the trace fields (its
    ``LaunchRecord``), no records, records short of a step, or no reader
    of records at all; and records that leave nothing to divide by."""
    ctx = _ctx()
    monkeypatch.setattr(tracing, "_launches", [ParentRecord(*r[:len(ParentRecord._fields)])
                                              for r in _records()])
    assert _reader(name).read(ctx) is None
    monkeypatch.setattr(tracing, "_launches", [])
    assert _reader(name).read(ctx) is None
    monkeypatch.setattr(tracing, "_launches", _records()[:-1])
    assert _reader(name).read(ctx) is None
    empty = [r._replace(trace_lane_iters=0, busy=0.0) for r in _records()]
    monkeypatch.setattr(tracing, "_launches", empty)
    assert _reader(name).read(ctx) is None
    monkeypatch.delattr(tracing, "launch_records")
    assert _reader(name).read(ctx) is None
