"""K3's share of its roofline: the least time one card could take for the
window's megastep work (the NIF operations its paths need over the
chain type's peak, or its bytes over HBM's, whichever is longer) over
the megastep kernels' summed device time in the window, in percent."""

from port_bench.counts import k3_least_seconds


def is_k3(name: str) -> bool:
    return "megastep" in name and "stub" not in name


def read(ctx):
    k3 = ctx.trace.in_window(is_k3)
    if not k3:
        return None
    spent = sum(e.t1 - e.t0 for e in k3)
    least, _ = k3_least_seconds(ctx.config, ctx.traffic, ctx.paths, ctx.records, len(k3))
    return 100.0 * least / spent
