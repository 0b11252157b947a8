"""How far the slowest card's megastep runs past the cards' mean in each
step, averaged over the window's steps, in percent: per step
max / mean - 1 of the four K3 kernels' device times (the k-th launch on
each card is step k's)."""

from port_bench.metrics.k3_roofline import is_k3


def read(ctx):
    per = ctx.trace.per_device(is_k3)
    if ctx.cards < 2 or len(per) != ctx.cards:
        return None
    steps = min(len(v) for v in per.values())
    if steps == 0 or any(len(v) != steps for v in per.values()):
        return None
    skew = 0.0
    for k in range(steps):
        t = [per[d][k].t1 - per[d][k].t0 for d in per]
        skew += max(t) / (sum(t) / len(t)) - 1.0
    return 100.0 * skew / steps
