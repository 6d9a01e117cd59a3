"""setup_s: loading, building the inputs and the warm-up calls (the
first run in a checkout also builds the kernels), from the start of
run.py to the window's first call; host clock."""


def read(run):
    return run.setup_s
