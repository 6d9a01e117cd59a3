"""chem_build_s: the wall of the program's equilibrium chemistry table
build (``FastChemTorch.build_seconds``: host clock, synchronized with
the build's device), handed on by the entry; set-up, ahead of the
window.  Nothing where the entry or the program has no such number."""


def read(run):
    return getattr(run.ctx, "chem_build_s", None)
