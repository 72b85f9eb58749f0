"""Host wall time to enqueue one chunk (its copy in, the replay, its copies
out, without waiting), the mean over every chunk of the untraced window,
in us."""


def read(ctx):
    enqueue = ctx.window.enqueue_s
    if enqueue is None or not len(enqueue):
        return None
    return float(enqueue.mean()) * 1e6
