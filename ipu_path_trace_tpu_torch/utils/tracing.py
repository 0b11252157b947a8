"""Named phase tracing: wall-clock spans per channel.

Counterpart of ``ipu_path_trace_tpu/utils/tracing.py`` (the reference's
PVTI tracepoints).  Each span also opens a
``torch.profiler.record_function`` named ``"<channel>/<span>"``, so the
spans appear in a ``--profile-dir`` trace beside the kernels they
enqueue.  Without an active profiler that is a no-op.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

from .logging import TRACE, logger


class TraceChannel:
    """A named channel accumulating (count, total_seconds) per span name."""

    def __init__(self, name: str):
        self.name = name
        self.spans: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])

    @contextlib.contextmanager
    def span(self, span_name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"{self.name}/{span_name}"):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                acc = self.spans[span_name]
                acc[0] += 1
                acc[1] += dt
                logger().log(TRACE, "span %s/%s: %.3fms", self.name, span_name, dt * 1e3)

    def total(self, span_name: str) -> float:
        return self.spans[span_name][1] if span_name in self.spans else 0.0

    def report(self) -> dict[str, dict]:
        return {k: {"count": int(c), "total_s": t, "mean_ms": 1e3 * t / c}
                for k, (c, t) in self.spans.items() if c}


@contextlib.contextmanager
def trace_span(channel: TraceChannel | None, name: str):
    if channel is None:
        yield
    else:
        with channel.span(name):
            yield
