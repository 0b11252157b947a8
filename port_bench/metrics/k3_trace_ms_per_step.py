"""Device ms of K3 in its trace phase a step (mean of cards): over the
window's K3 launches, the blocks' summed trace time (thread 0's clock
from each sample's start to the barrier that ends the sample's trace)
over their summed run time, times K3's span a step, from the program's
per-block records (held to the device trace, ``k3_sm_fill_pct.launches``).
The rest of K3's time is the NIF chain and the sample's bookkeeping."""

from port_bench.metrics.k3_sm_fill_pct import launches


def read(ctx):
    recs = launches(ctx)
    if recs is None or not all(hasattr(r, "trace_busy") for r in recs):
        return None
    busy = sum(r.busy for r in recs)
    if busy <= 0:
        return None
    share = sum(r.trace_busy for r in recs) / busy
    return 1e3 * share * sum(r.span for r in recs) / (ctx.steps * ctx.cards)
