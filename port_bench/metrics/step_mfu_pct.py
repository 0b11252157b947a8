"""The whole step's share of the cards' peak: the NIF operations the
window's paths need over (the window's host-clock seconds x the chain
type's peak x the cards used), in percent.  Whatever a later change does
inside the step, this share bounds what it gained end to end."""

from port_bench.counts import PEAK_OPS, nif_ops


def read(ctx):
    if ctx.paths <= 0 or ctx.window_s <= 0:
        return None
    peak = PEAK_OPS[ctx.config["nif_precision"]] * ctx.cards
    return 100.0 * nif_ops(ctx.config, ctx.paths) / (ctx.window_s * peak)
