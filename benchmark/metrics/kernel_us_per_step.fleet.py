"""Device time of the port's own kernels (the frozen name lists) per chunk
step in the traced window, in us."""


def read(ctx):
    t = ctx.trace
    if t is None or t.port_s <= 0.0 or not ctx.traced.steps:
        return None
    return t.port_s / ctx.traced.steps * 1e6
