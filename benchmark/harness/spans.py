"""The program's own spans and counters: the registry of
``radiorust_tpu_torch.utils.profiling`` (``snapshot()``), read once the
traced window has closed.  The entry records its per-call spans and
counters only while a profiler records, which in a run is the traced
window alone; the capture and the kernel library's load are recorded
always.  A program without the registry reads as empty: its metrics are
left out, nothing raises."""

from __future__ import annotations


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_ns", "self_ns"}}, "counters":
    {name: n}}``, empty where the program has no such registry."""
    try:
        from radiorust_tpu_torch.utils import profiling
    except ImportError:
        return {"spans": {}, "counters": {}}
    snap = getattr(profiling, "snapshot", None)
    if snap is None:
        return {"spans": {}, "counters": {}}
    return snap()


def span(name: str, snap: dict = None):
    """Span ``name`` ({"count", "total_ns", "self_ns"}), or None where it
    never ran."""
    s = (snapshot() if snap is None else snap)["spans"].get(name)
    return s if s and s["count"] else None


def counter(name: str, snap: dict = None):
    """Counter ``name``, or None where it never counted."""
    return (snapshot() if snap is None else snap)["counters"].get(name)


def per_call_us(name: str, field: str):
    """Span ``name``'s ``field`` (``total_ns`` or ``self_ns``) over the
    entry's calls (``entry.calls``), in us; None where either is
    missing."""
    snap = snapshot()
    s, n = span(name, snap), counter("entry.calls", snap)
    if s is None or not n:
        return None
    return s[field] / n / 1e3


def copy_mb_per_step():
    """The entry's copies in and clones out over ``entry.steps``, in MB
    (1e6 bytes)."""
    snap = snapshot()
    steps = counter("entry.steps", snap)
    parts = [counter(k, snap)
             for k in ("entry.copy_in_bytes", "entry.clone_out_bytes")]
    if not steps or None in parts:
        return None
    return sum(parts) / steps / 1e6
