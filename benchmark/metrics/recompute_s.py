"""recompute_s: the union of the program's ``frei.remat.recompute``
spans (the checkpoints' replays of the forward inside the backward;
nested checkpoints nest their replays, so each instant counts once)
over the traced steps, in s.  Host time under the profiler: it holds
the profiler's cost per operation and the waits on kernel launches, so
it moves with the replays' host cost but is no share of ``backward_s``
(a synchronized split of the backward reads the replays lower).
Nothing when the trace has no such span."""

from benchmark.harness.spans import named, union_ns


def read(run):
    t = run.window.trace
    spans = named(t, "frei.remat.recompute")
    if not spans:
        return None
    return union_ns(spans) / 1e9 / len(t.calls)
