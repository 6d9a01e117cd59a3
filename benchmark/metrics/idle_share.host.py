"""idle_share.host: as idle_share.forward, in the forward cells whose
calls the host paces."""

from benchmark.harness.trace import idle_share


def read(run):
    return idle_share(run.window.trace)
