"""Named phase tracing: spans on a channel, and K3's per-block
records.

Counterpart of ``ipu_path_trace_tpu/utils/tracing.py`` (the reference's
PVTI tracepoints).  Each span also opens a
``torch.profiler.record_function`` named ``"<channel>/<span>"``, so the
spans appear in a profiler trace beside the kernels they enqueue, on
Kineto's clock.  Without an active profiler that is a no-op.

A channel keeps each span name's (count, total seconds) (``report``).
Tracing is on while a torch profiler records in the process
(``profiling``: the app's ``--profile-dir``, whose profiler records every
thread, or an embedding program's profiler); a span's own times are its
range in the profiler's trace.

``TraceChannel.loop()`` makes a channel current for a render loop
(``runtime/app.py::execute``); module code opens spans on it with the
module-level ``span``, which does nothing while no channel is
current, so a probe or a test that calls a step directly pays nothing.

K3's per-block records (csrc/megastep.cuh): while tracing is on,
``ops/megastep.render_megastep`` hands each launch's record buffer to the
current channel (``keep_launch``), with no copy and no sync in the step.
When the loop ends the channel copies each buffer once and reduces it to
a ``LaunchRecord`` (``launch_record``, pure arithmetic on the stamps);
``launch_records()`` returns the last traced loop's records, which
outlive the app.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

from .logging import TRACE, logger

# The words of one block's record, int64 (csrc/megastep.cuh kStampWords):
# start and end (%globaltimer, ns), the SM, the live lane-samples, the
# lane-samples that escaped, the escape queue's tiles it shaded; the trace
# phase's ns (thread 0, each sample's start to the barrier that ends its
# trace), the lane-iterations its warps held in the bounce loop (32 x the
# warp's most bounces, a warp and a sample) and the bounce iterations its
# lanes ran.
STAMP_WORDS = 9


class LaunchRecord(NamedTuple):
    """One K3 launch, from its blocks' records; times in seconds."""

    device: int
    step: int
    launch: int  # the launch's index on its device within the step
    blocks: int
    written: int  # blocks whose record holds a start and an end
    slots: int  # the most blocks seen running at once
    waves: float  # blocks / slots
    span: float  # last end - first start
    busy: float  # sum of (end - start) over the blocks
    fill: float  # busy / (slots x span)
    tail: float  # last end - last start
    lane_samples: int
    escapes: int
    tile_passes: int
    tile_rays: int  # rays of one chain tile (128; 64 for the f32 chain)
    escape_share: float  # escapes / lane_samples
    chain_useful_share: float  # escapes / (tile_passes x tile_rays)
    trace_busy: float  # sum of the blocks' trace-phase time
    trace_lane_iters: int
    trace_bounces: int


def concurrency(starts: np.ndarray, ends: np.ndarray) -> int:
    """The most intervals [start, end) open at once (an end at t closes
    before a start at t opens)."""
    if len(starts) == 0:
        return 0
    t = np.concatenate([starts, ends])
    d = np.concatenate([np.ones(len(starts), np.int64), -np.ones(len(ends), np.int64)])
    order = np.lexsort((d, t))  # by time, ends first
    return int(np.cumsum(d[order]).max())


def launch_record(stamps: np.ndarray, *, device: int = 0, step: int = 0, launch: int = 0,
                  tile_rays: int = 128) -> LaunchRecord:
    """A launch's record from its (blocks, STAMP_WORDS) int64 stamps."""
    stamps = np.asarray(stamps, dtype=np.int64).reshape(-1, STAMP_WORDS)
    blocks = len(stamps)
    ok = (stamps[:, 0] > 0) & (stamps[:, 1] >= stamps[:, 0])
    s = stamps[ok]
    start, end = s[:, 0], s[:, 1]
    lanes, esc, passes, trace_ns, lane_iters, bounces = (int(s[:, k].sum()) for k in range(3, 9))
    slots = concurrency(start, end)
    span = 1e-9 * float(end.max() - start.min()) if len(s) else 0.0
    busy = 1e-9 * float((end - start).sum())
    return LaunchRecord(
        device=device, step=step, launch=launch, blocks=blocks, written=int(ok.sum()),
        slots=slots, waves=blocks / slots if slots else 0.0, span=span, busy=busy,
        fill=busy / (slots * span) if slots and span > 0 else 0.0,
        tail=1e-9 * float(end.max() - start.max()) if len(s) else 0.0,
        lane_samples=lanes, escapes=esc, tile_passes=passes, tile_rays=tile_rays,
        escape_share=esc / lanes if lanes else 0.0,
        chain_useful_share=esc / (passes * tile_rays) if passes else 0.0,
        trace_busy=1e-9 * trace_ns, trace_lane_iters=lane_iters, trace_bounces=bounces)


_current: TraceChannel | None = None
_launches: list[LaunchRecord] = []  # the last traced loop's K3 launches


def launch_records() -> list[LaunchRecord]:
    """The K3 launches of the last traced loop, in launch order (empty
    before one, and in a process that never traced)."""
    return list(_launches)


def profiling() -> bool:
    """A torch profiler records in the process.  The flag torch.profiler
    sets for its run; ``torch.autograd._profiler_enabled()`` is per thread,
    and reads False on every thread under ``profile_all_threads`` (the
    app's ``--profile-dir``)."""
    flag = getattr(torch.autograd.profiler, "_is_profiler_enabled", None)
    return torch.autograd._profiler_enabled() if flag is None else flag


def tracing_on() -> bool:
    """A channel is current and a profiler records."""
    return _current is not None and profiling()


@contextlib.contextmanager
def span(name: str):
    """A span on the current channel; nothing without one."""
    chan = _current
    if chan is None:
        yield
        return
    with chan.span(name):
        yield


def keep_launch(stamps: torch.Tensor, tile_rays: int) -> None:
    """Hand a K3 launch's record buffer to the current channel (called by
    ops/megastep.py only while ``tracing_on()``)."""
    _current.keep_launch(stamps, tile_rays)


class TraceChannel:
    """A named channel of spans: (count, total seconds) per span name,
    and while tracing is on a profiler range per span (module docstring)."""

    def __init__(self, name: str):
        self.name = name
        self.spans: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])
        self.step = 0  # set by the loop before each step (for K3's records)
        self._pending: list[tuple[int, int, int, torch.Tensor, int]] = []

    @contextlib.contextmanager
    def span(self, span_name: str):
        # The clock is read just inside the profiler range and the
        # bookkeeping done outside it.  Without any profiler in the process
        # the range records nothing (and costs more than the rest of the
        # span), so none is opened.
        t0 = t1 = 0.0
        try:
            with (torch.profiler.record_function(f"{self.name}/{span_name}") if profiling()
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    t1 = time.perf_counter()
        finally:
            dt = t1 - t0
            acc = self.spans[span_name]
            acc[0] += 1
            acc[1] += dt
            logger().log(TRACE, "span %s/%s: %.3fms", self.name, span_name, dt * 1e3)

    def report(self) -> dict[str, dict]:
        return {k: {"count": int(c), "total_s": t, "mean_ms": 1e3 * t / c}
                for k, (c, t) in self.spans.items() if c}

    def keep_launch(self, stamps: torch.Tensor, tile_rays: int) -> None:
        """Keep a K3 launch's record buffer, as (device, step, launch) of
        the current step, until the loop ends."""
        device = stamps.device.index or 0
        launch = sum(1 for d, s, *_ in self._pending if (d, s) == (device, self.step))
        self._pending.append((device, self.step, launch, stamps, tile_rays))

    @contextlib.contextmanager
    def loop(self):
        """Make this the current channel for a render loop, and the
        previous one again on exit.  A traced loop (a profiler recording
        at its start) clears the last traced loop's K3 records.  On exit
        the K3 buffers are copied and reduced to ``LaunchRecord``s."""
        global _current
        if profiling():
            _launches.clear()
        self.step = 0
        prev, _current = _current, self
        try:
            yield self
        finally:
            _current = prev
            self._finish_launches()

    def _finish_launches(self) -> None:
        pending, self._pending = self._pending, []
        _launches.extend(launch_record(stamps.cpu().numpy(), device=device, step=step,
                                       launch=launch, tile_rays=tile_rays)
                         for device, step, launch, stamps, tile_rays in pending)
