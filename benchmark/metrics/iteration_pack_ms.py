"""iteration_pack_ms: the summed duration of the program's
``frei.iteration.pack`` spans (the whole-iteration kernels' constants:
the layer tables, a population's per-column F_toa and dtau-factor rows,
the chemistry's layer tables nested inside) that lie inside a
``frei.solve`` span, over the traced calls, in ms.  Nothing when the
trace has no such span."""

from benchmark.harness.spans import named


def read(run):
    t = run.window.trace
    solves = named(t, "frei.solve")
    inside = [(s, e) for s, e in named(t, "frei.iteration.pack")
              if any(a <= s and e <= b for a, b in solves)]
    if not inside:
        return None
    return sum(e - s for s, e in inside) / 1e6 / len(t.calls)
