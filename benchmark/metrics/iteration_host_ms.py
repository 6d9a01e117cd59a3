"""iteration_host_ms: the mean duration of the program's
``frei.solver.iteration`` spans in the traced calls, in ms: the host's
time to issue one RC iteration, the kernel launches included, the
per-iteration read of the convergence flags outside it.  Nothing when
the trace has no such span."""

from benchmark.harness.spans import named


def read(run):
    spans = named(run.window.trace, "frei.solver.iteration")
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e6 / len(spans)
