"""The share of K3's NIF chain lanes that shaded an escaped path, in
percent: over the window's K3 launches, the escaped lane-samples over
(the chain tile passes x the tile's rays), from the program's per-block
records (held to the device trace, ``k3_sm_fill_pct.launches``).  The
chain runs on whole tiles and skips only a tile with no escape, so the
lanes of paths that did not escape are chain work done for nothing."""

from port_bench.metrics.k3_sm_fill_pct import launches


def read(ctx):
    recs = launches(ctx)
    if recs is None:
        return None
    lanes = sum(r.tile_passes * r.tile_rays for r in recs)
    return 100.0 * sum(r.escapes for r in recs) / lanes if lanes else None
