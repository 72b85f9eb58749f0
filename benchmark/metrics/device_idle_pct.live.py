"""Share of the traced window in which no kernel and no copy ran on the
card, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_ops or t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
