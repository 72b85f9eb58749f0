"""Device operations (kernels, copies, memsets) per chunk step in the
traced window, from the profiler."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_ops or not ctx.traced.steps:
        return None
    return t.n_ops / ctx.traced.steps
