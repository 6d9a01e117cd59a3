"""idle_share.forward: 1 - (union of device activity) / (the traced
window: the first traced call's start to the synchronize after the
last), in %, in the forward cells whose calls the device paces."""

from benchmark.harness.trace import idle_share


def read(run):
    return idle_share(run.window.trace)
