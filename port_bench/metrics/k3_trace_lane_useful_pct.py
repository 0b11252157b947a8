"""The share of K3's trace lane-iterations that traced a bounce, in
percent: over the window's K3 launches, the bounce iterations the lanes
ran over the lane-iterations their warps held (32 x the warp's most
bounces, a warp and a sample: a warp runs until its longest path ends),
from the program's per-block records (held to the device trace,
``k3_sm_fill_pct.launches``).  Short paths beside long ones in a warp
leave its lanes idle."""

from port_bench.metrics.k3_sm_fill_pct import launches


def read(ctx):
    recs = launches(ctx)
    if recs is None or not all(hasattr(r, "trace_lane_iters") for r in recs):
        return None
    held = sum(r.trace_lane_iters for r in recs)
    return 100.0 * sum(r.trace_bounces for r in recs) / held if held else None
