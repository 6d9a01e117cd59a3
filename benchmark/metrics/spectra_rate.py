"""spectra_rate: columns x bins of every call completed in the window,
over the window from its first call to the synchronize after its last;
host clock.  The cells whose calls the device paces."""

from benchmark.harness.window_metrics import rate


def read(run):
    return rate(run)
