"""The window's end-to-end arithmetic, shared by the metric readers."""

import numpy as np


def rate(run) -> float:
    """columns x bins of every call completed, over the window."""
    w = run.window
    return run.ctx.columns * run.ctx.bins * len(w.walls) / w.seconds


def p95_ms(run) -> float:
    """The 95th percentile of every call's wall, in ms."""
    return float(np.percentile(run.window.walls, 95)) * 1e3
