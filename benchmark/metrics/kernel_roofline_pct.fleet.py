"""The port's kernels' share of their roofline in the traced window: the
least time the card could take for the kernel work the window's steps
need (the configuration's kernel calls, counted by
``benchmark/counts/roofline.py``), over the device time of the port's
kernels, in %."""

from benchmark.counts.roofline import least_seconds


def read(ctx):
    t = ctx.trace
    if t is None or t.port_s <= 0.0 or not ctx.traced.steps:
        return None
    least = sum(least_seconds(flops, nbytes)
                for _, flops, nbytes, _ in ctx.work)
    return 100.0 * least * ctx.traced.steps / t.port_s
