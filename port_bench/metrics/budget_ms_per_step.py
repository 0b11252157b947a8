"""Device time of everything the adaptive step runs besides the megastep
kernel (the budget controller, the accumulation, copies), per step of
the window, in milliseconds."""

from port_bench.metrics.k3_roofline import is_k3


def read(ctx):
    if not ctx.traffic.get("adaptive") or ctx.steps <= 0:
        return None
    if not ctx.trace.in_window(is_k3):
        return None
    return 1e3 * ctx.trace.device_time(lambda name: not is_k3(name)) / ctx.steps
