"""Device time of the chunks' host-to-device copies per chunk in the
traced window, in us."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced.steps or t.h2d_s <= 0.0:
        return None
    return t.h2d_s / ctx.traced.steps * 1e6
