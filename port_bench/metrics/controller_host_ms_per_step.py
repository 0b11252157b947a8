"""Host time of the adaptive controller, in milliseconds a step: the
window's ``compute_budgets`` ranges (the program's span around
``render/adaptive.compute_budgets``: the launches of its element-wise
kernels and reductions) summed and divided by the window's steps."""

SPAN = "tpu_path_tracer/compute_budgets"


def read(ctx):
    w0, w1 = ctx.trace.window
    spans = [r for r in ctx.trace.ranges if r.name == SPAN and w0 <= r.t0 < w1]
    if not spans or ctx.steps <= 0:
        return None
    return 1e3 * sum(r.t1 - r.t0 for r in spans) / ctx.steps
