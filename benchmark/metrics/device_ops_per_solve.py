"""device_ops_per_solve: kernels, memcpys and memsets in the trace per
traced call, in the cells whose calls the device paces."""

from benchmark.harness.trace import ops_per_call


def read(run):
    return ops_per_call(run.window.trace)
