"""spectra_rate.host: as spectra_rate, in the cells whose calls the
host paces (their runs spread by ten times more, so they have a bound
of their own)."""

from benchmark.harness.window_metrics import rate


def read(run):
    return rate(run)
