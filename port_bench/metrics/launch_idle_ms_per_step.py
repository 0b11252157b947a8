"""Device idle while the host launches a step, in milliseconds a step:
the time inside each step's ``ipu_render`` range before its
``device_sync`` or ``device_fetch`` range begins in which a card runs
nothing, the mean over the cards, summed over the window's steps and
divided by them."""

STEP = "tpu_path_tracer/ipu_render"
WAITS = ("tpu_path_tracer/device_sync", "tpu_path_tracer/device_fetch")


def step_ranges(trace):
    """The window's step ranges, in order."""
    w0, w1 = trace.window
    return sorted((r for r in trace.ranges if r.name == STEP and w0 <= r.t0 and r.t1 <= w1),
                  key=lambda r: r.t0)


def idle_s(trace, a: float, b: float, cards: int) -> float:
    """Seconds of [a, b] in which a card runs nothing, the mean over the
    cards."""
    if b <= a:
        return 0.0
    idle = 0.0
    for d in range(cards):
        busy = sum(max(0.0, min(y, b) - max(x, a)) for x, y in trace.busy_intervals(d))
        idle += (b - a) - busy
    return idle / cards


def read(ctx):
    steps = step_ranges(ctx.trace)
    waits = [r for r in ctx.trace.ranges if r.name in WAITS]
    if not steps or not waits:
        return None
    total = 0.0
    for s in steps:
        inside = [w.t0 for w in waits if s.t0 <= w.t0 < s.t1]
        if not inside:
            return None
        total += idle_s(ctx.trace, s.t0, min(inside), ctx.cards)
    return 1e3 * total / len(steps)
