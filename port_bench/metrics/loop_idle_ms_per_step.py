"""Device idle between steps, in milliseconds a step: the time between
one step's ``ipu_render`` range and the next's (the host waits for its
task, logs, checks for a stop and a UI) in which a card runs nothing, the
mean over the cards, summed over the window and divided by its steps."""

from port_bench.metrics.launch_idle_ms_per_step import idle_s, step_ranges


def read(ctx):
    steps = step_ranges(ctx.trace)
    if not steps:
        return None
    total = sum(idle_s(ctx.trace, a.t1, b.t0, ctx.cards) for a, b in zip(steps, steps[1:]))
    return 1e3 * total / len(steps)
