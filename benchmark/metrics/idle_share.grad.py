"""idle_share.grad: as idle_share.forward, in the gradient cells."""

from benchmark.harness.trace import idle_share


def read(run):
    return idle_share(run.window.trace)
