"""Device time of every operation that is not one of the port's kernels
(PyTorch's kernels, cuFFT, copies) per chunk step in the traced window,
in us."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_ops or not ctx.traced.steps:
        return None
    return t.glue_s / ctx.traced.steps * 1e6
