"""grad_rate: columns x bins of every (forward + backward) step
completed in the window, over the window; host clock."""

from benchmark.harness.window_metrics import rate


def read(run):
    return rate(run)
