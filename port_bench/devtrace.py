"""The traced run's view of the device: a ``torch.profiler`` trace (CPU and
CUDA activities) of the window, read back from its Chrome-format export.

Device events are the kernels, copies and fills CUPTI saw on each card;
host ranges are the ``record_function`` ranges open on the host: the
renderer's spans (``tpu_path_tracer/<span>``) and the harness's own
``port_bench/window`` around the run it times.  The window runs from the
start of the first ``tpu_path_tracer/ipu_render`` range in that range
(the first step) to the end of the last (the end of the last step the
window took).  Times are in seconds.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import NamedTuple

WINDOW_RANGE = "port_bench/window"
STEP_RANGE = "tpu_path_tracer/ipu_render"
SPAN_PREFIX = "tpu_path_tracer/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Event(NamedTuple):
    name: str
    device: int
    t0: float
    t1: float


class Range(NamedTuple):
    name: str
    t0: float
    t1: float


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class DeviceTrace:
    def __init__(self, doc: dict):
        self.events: list[Event] = []
        self.ranges: list[Range] = []
        for e in doc.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e["dur"]) * 1e-6
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.events.append(Event(e.get("name", ""), int(e.get("args", {}).get(
                    "device", 0)), t0, t1))
            elif cat == "user_annotation":
                self.ranges.append(Range(e.get("name", ""), t0, t1))
        outer = [r for r in self.ranges if r.name == WINDOW_RANGE]
        if not outer:
            raise ValueError("the trace holds no window")
        steps = [r for r in self.ranges if r.name == STEP_RANGE and r.t0 >= outer[0].t0]
        if not steps:
            raise ValueError("the trace holds no step")
        self.window = (min(r.t0 for r in steps), max(r.t1 for r in steps))
        self.steps = len(steps)

    @staticmethod
    def load(path: str) -> "DeviceTrace":
        with open(path) as f:
            return DeviceTrace(json.load(f))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self, select=None) -> list[Event]:
        """Device events that start inside the window (``select(name)``)."""
        w0, w1 = self.window
        return [e for e in self.events if w0 <= e.t0 < w1 and (select is None or select(e.name))]

    def devices(self) -> list[int]:
        return sorted({e.device for e in self.in_window()})

    def busy_intervals(self, device: int) -> list[tuple[float, float]]:
        w0, w1 = self.window
        return _union([(max(e.t0, w0), min(e.t1, w1)) for e in self.in_window()
                       if e.device == device])

    def busy_s(self, device: int) -> float:
        return sum(b - a for a, b in self.busy_intervals(device))

    def device_time(self, select) -> float:
        """Summed device time, over all cards, of the window's events that
        ``select(name)`` picks."""
        return sum(e.t1 - e.t0 for e in self.in_window(select))

    def per_device(self, select) -> dict[int, list[Event]]:
        out: dict[int, list[Event]] = defaultdict(list)
        for e in sorted(self.in_window(select), key=lambda e: e.t0):
            out[e.device].append(e)
        return dict(out)

    def top_ops(self, n: int = 10) -> list[list]:
        """The device operations that took the most time, summed by name."""
        total: dict[str, float] = defaultdict(float)
        for e in self.in_window():
            total[e.name] += e.t1 - e.t0
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def host_span_at(self, t: float) -> str:
        """The innermost renderer span open on the host at ``t``; between
        spans, "after" the one that ended last."""
        spans = [r for r in self.ranges if r.name.startswith(SPAN_PREFIX)]
        open_ = [r for r in spans if r.t0 <= t < r.t1]
        if open_:
            return min(open_, key=lambda r: r.t1 - r.t0).name
        ended = [r for r in spans if r.t1 <= t]
        return "after " + max(ended, key=lambda r: r.t1).name if ended else "none"

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The window's longest idle gaps over all cards, each named by the
        renderer span the host had open at its middle."""
        gaps = []
        w0, w1 = self.window
        for dev in self.devices():
            cur = w0
            for a, b in self.busy_intervals(dev) + [(w1, w1)]:
                if a > cur:
                    gaps.append((a - cur, 0.5 * (a + cur)))
                cur = max(cur, b)
        gaps.sort(reverse=True)
        return [[self.host_span_at(mid), length] for length, mid in gaps[:n]]
