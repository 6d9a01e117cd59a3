"""iterations_per_column: the mean of the program's per-column
iteration counts (``RTResult.n_iterations``) over the window's calls,
each call's mean handed on by the entry after its synchronize.
Nothing where the entry hands none on."""


def read(run):
    means = run.ctx.spans.get("n_iterations")
    return sum(means) / len(means) if means else None
