"""The entry's host time a call (``rr.entry``, the program's span around
``_Compiled.__call__``) over the traced window's calls
(``entry.calls``), in us."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_call_us("rr.entry", "total_ns")
