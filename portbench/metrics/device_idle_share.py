"""The share of the traced block's window, in %, in which no operation ran
on the card: one less the union of the device activities' intervals over
the window, from ``torch.profiler``."""


def read(ctx):
    t = ctx.trace
    if not t.window_s or not t.activities:
        return None
    return 100 * (1 - t.busy_s / t.window_s)
