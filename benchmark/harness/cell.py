"""One run of one cell: set-up, the timed window, the check against the
reference, and the metrics.  ``run.py`` drives it on the card; the CPU
tests drive it on the CPU at a small size."""

from __future__ import annotations

import time
import traceback
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..reference import case, inputs
from . import pieces

#: the entries' spans and the idle gaps they are named by
CALL_SPAN = "bench.call"


class Context:
    """What an entry and a metric reader see of a run: the cell, its
    configuration and traffic, the seed, the device and the raw inputs
    both sides are given."""

    def __init__(self, cell_name: str, seed: int, device, man=None,
                 overrides: Optional[dict] = None, spans: bool = False):
        man = pieces.manifest() if man is None else man
        self.cell = pieces.cell(man, cell_name)
        self.cfg = pieces.config(self.cell["config"])
        self.traffic = {**pieces.traffic(self.cell["traffic"]),
                        **(overrides or {})}
        self.limits = pieces.limits(cell_name)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.dtype = getattr(torch, self.cfg["dtype"])
        self.grid = inputs.grid_arrays(self.cfg["grid"])
        self.tables = case.opacity_tables(self.cfg, self.grid)
        self.record_spans = spans
        self.spans = defaultdict(list)

    def rng(self, stream: int):
        return inputs.rng_for(self.seed, stream)

    @property
    def columns(self) -> int:
        return int(self.traffic["columns"])

    @property
    def bins(self) -> int:
        return int(self.cfg["grid"]["n_wl_bins"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str, seconds: float):
        self.spans[name].append(seconds)


class Reservoir:
    """A uniform sample of ``n`` of the window's calls, drawn from the
    seed before each call (Algorithm R), so that the calls kept for the
    check are any of the window's and the draw never depends on what a
    call returns."""

    def __init__(self, n: int, rng):
        self.n, self.rng = n, rng

    def slot(self, k: int):
        if k < self.n:
            return k
        j = int(self.rng.integers(0, k + 1))
        return j if j < self.n else None


@dataclass
class Window:
    walls: list = field(default_factory=list)   # each call's wall [s]
    seconds: float = 0.0    # first call's start to the last call's sync
    failed: int = 0
    kept: dict = field(default_factory=dict)
    trace: object = None    # trace.Summary of the profiled calls


def run_window(ctx: Context, entry, state, seconds: float,
               profile_calls: int = 0) -> Window:
    """Calls back to back until ``seconds`` have passed; each ends in a
    synchronize.  The first ``profile_calls`` run under torch.profiler."""
    from . import trace
    w = Window()
    keep = Reservoir(int(ctx.traffic["check_calls"]), ctx.rng(2))
    prof = trace.start() if profile_calls else None
    start = time.perf_counter()
    k = 0
    while True:
        slot = keep.slot(k)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(CALL_SPAN):
                rec = entry.call(ctx, state, k, slot is not None)
        except Exception:  # noqa: BLE001 - a failed call is counted
            traceback.print_exc()
            w.failed += 1
            rec = None
        t1 = time.perf_counter()
        w.walls.append(t1 - t0)
        if rec is not None:
            w.kept[slot] = rec
        k += 1
        if prof is not None and k == profile_calls:
            w.trace = trace.stop(prof)
            prof = None
        if t1 - start >= seconds or w.failed > 3:
            w.seconds = t1 - start
            break
    if prof is not None:
        w.trace = trace.stop(prof)
    return w


def check(ctx: Context, entry, kept: dict, dtype=torch.float64) -> dict:
    """The largest of each gap over the kept calls, the reference run in
    ``dtype`` on the run's device."""
    worst = {}
    for rec in kept.values():
        ref = entry.reference(ctx, rec, dtype)
        for name, v in entry.gaps(ctx, rec, ref).items():
            worst[name] = max(worst.get(name, -np.inf), v)
    return worst


def judged(gaps: dict, limits: dict) -> dict:
    """Each compared number beside its limit, in the limits file's
    order; a number the run did not produce reads infinite."""
    return {name: {"value": gaps.get(name, float("inf")),
                   "limit": lim["limit"]}
            for name, lim in limits.items()}


@dataclass
class Run:
    """What a metric reader reads: the context, the window and the
    set-up time."""

    ctx: Context
    window: Window
    setup_s: float

    def shape(self):
        """(L, W, S, nT): layers, bins, species and table temperatures."""
        g = self.ctx.cfg["grid"]
        values = next(iter(self.ctx.tables.values()))[0]
        return (int(g["n_layers"]), int(g["n_wl_bins"]),
                len(self.ctx.tables), int(values.shape[0]))


def read_metrics(run: Run, metrics: list) -> dict:
    """``{name: {"value", "unit"}}`` of each metric whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        v = pieces.reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
