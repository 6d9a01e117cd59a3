"""The program's own spans (``frei_tpu_torch.diag.telemetry.span``,
``record_function`` ranges named ``frei.*``) in a traced window, read
from the host events that ``trace.stop`` keeps.  A program without a
span of the name gives nothing to read."""

from __future__ import annotations


def named(t, name: str) -> list:
    """(start_ns, end_ns) of each span ``name`` in the trace ``t``, in
    start order; empty without a trace or a traced call."""
    if not t or not t.calls:
        return []
    return sorted((s, s + d) for n, s, d in t.host if n == name)


def union_ns(intervals: list) -> int:
    """The length of the union of sorted (start, end) intervals: a
    nested or overlapping span counts once."""
    total, end = 0, None
    for s, e in intervals:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total
