"""device_ops_per_solve.host: as device_ops_per_solve, in the cells
whose calls the host paces."""

from benchmark.harness.trace import ops_per_call


def read(run):
    return ops_per_call(run.window.trace)
