"""How full K3 keeps the SMs it runs on, in percent: over the window's K3
launches, the blocks' summed run time over (the most blocks seen running
at once x the launch's span from the first block's start to the last
block's end), from the per-block records the program keeps while a
profiler records (``utils/tracing.launch_records``).  A last wave that
fills few SMs, or a block that runs long after the rest, lowers it.

The records are the kernel's own account of itself, so each launch's
span is held to its kernel's duration in the device trace."""

from port_bench.metrics.k3_roofline import is_k3

SPAN_TOLERANCE = 0.02  # a record's span against its CUPTI kernel duration


def launches(ctx):
    """The window's K3 launch records, or None unless there is one for
    each step on each card (the program keeps none before it had them)
    and each card's records, in launch order, match its K3 kernels in the
    device trace one for one, each span within 2% of its kernel's
    duration."""
    from ipu_path_trace_tpu_torch.utils import tracing

    read = getattr(tracing, "launch_records", None)
    if read is None:
        return None
    recs = read()
    if not recs or len(recs) != ctx.steps * ctx.cards:
        return None
    kernels = ctx.trace.per_device(is_k3)
    if set(kernels) != {r.device for r in recs}:
        return None
    for dev, events in kernels.items():
        mine = sorted((r for r in recs if r.device == dev), key=lambda r: (r.step, r.launch))
        if len(mine) != len(events):
            return None
        for r, e in zip(mine, events):
            if abs(r.span - (e.t1 - e.t0)) > SPAN_TOLERANCE * (e.t1 - e.t0):
                return None
    return recs


def read(ctx):
    recs = launches(ctx)
    if recs is None:
        return None
    room = sum(r.slots * r.span for r in recs)
    return 100.0 * sum(r.busy for r in recs) / room if room > 0 else None
