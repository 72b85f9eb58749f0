"""Complex input samples the chain consumed, all streams, over the whole
window (all its work and all its time), in Msamples/s."""


def read(ctx):
    w = ctx.window
    return w.samples / w.seconds / 1e6 if w.calls else None
