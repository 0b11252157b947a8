"""The share of the window in which no kernel, copy or fill runs on a
card, in percent; the mean over the cards the run uses."""


def read(ctx):
    if not ctx.trace.events or ctx.trace.window_s <= 0:
        return None
    busy = [ctx.trace.busy_s(d) for d in range(ctx.cards)]
    return 100.0 * (1.0 - sum(busy) / len(busy) / ctx.trace.window_s)
