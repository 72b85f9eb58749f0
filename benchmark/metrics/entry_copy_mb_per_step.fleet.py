"""Bytes the entry copies into the graph's buffers and clones out of them
(``entry.copy_in_bytes`` + ``entry.clone_out_bytes``) a chunk step in the
traced window (``entry.steps``), in MB."""

from benchmark.harness import spans


def read(ctx):
    return spans.copy_mb_per_step()
