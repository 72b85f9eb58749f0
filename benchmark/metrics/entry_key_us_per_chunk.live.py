"""The self time of finding the graph a call (``rr.entry.key``: the
trees' specs, the dict lookup, the params check) over the traced
window's calls (``entry.calls``), in us."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_call_us("rr.entry.key", "self_ns")
