"""population_build_ms: the summed duration of the program's
``frei.population.build`` spans (``parallel.solve_population``'s
per-planet F_toa rows, g and alpha, and their upload to the device)
over the traced calls, in ms.  Nothing when the trace has no such
span."""

from benchmark.harness.spans import named


def read(run):
    t = run.window.trace
    spans = named(t, "frei.population.build")
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e6 / len(t.calls)
