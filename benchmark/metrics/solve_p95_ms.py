"""solve_p95_ms: the 95th percentile of every call's wall in the window
(host clock from the call to the synchronize after it), in ms.  The
cells whose calls the device paces."""

from benchmark.harness.window_metrics import p95_ms


def read(run):
    return p95_ms(run)
