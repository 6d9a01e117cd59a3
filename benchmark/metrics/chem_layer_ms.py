"""chem_layer_ms: the summed duration of the program's
``frei.chemistry.layer_tables`` spans (the chemistry's ln-MMR table
interpolated onto the layers for the whole-iteration kernels' pack) that
lie inside a ``frei.solve`` span, over the traced calls, in ms: the
solves' own chemistry, not the entry's copy for the check.  Nothing when
the trace has no such span."""

from benchmark.harness.spans import named


def read(run):
    t = run.window.trace
    solves = named(t, "frei.solve")
    inside = [(s, e) for s, e in named(t, "frei.chemistry.layer_tables")
              if any(a <= s and e <= b for a, b in solves)]
    if not inside:
        return None
    return sum(e - s for s, e in inside) / 1e6 / len(t.calls)
