"""Observability: solve metrics, progress lines, profiling, spans, NaN
checks.

Counterpart of ``frei_tpu.diag.telemetry``: the reference's tqdm line
(`frei/core.py:269-271,312-315`) as :func:`progress_printer`,
structured per-solve metrics, a ``torch.profiler`` trace context, the
program's named spans (:func:`span`) and a NaN-debugging toggle.  Torch
has no ``jax_debug_nans``, so the toggle sets a flag that the solver and
the standalone drivers read: when it is on they check every sweep's
outputs and raise ``FloatingPointError`` naming the sweep and the
iteration.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

__all__ = ["SolveMetrics", "flux_balance", "progress_printer",
           "profile_trace", "span", "enable_nan_debugging"]

# read by rt.solver and rt.standalone; set by enable_nan_debugging
_NAN_CHECKS = False
# what span() returns while no profiler records
_OFF = contextlib.nullcontext()


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclass
class SolveMetrics:
    """Structured summary of one radiative-convective solve."""

    n_iterations: int
    converged_layers: int       # layers converged (in every column, if batched)
    n_layers: int
    max_dT_history: np.ndarray
    wall_seconds: float
    columns: int = 1
    bins: int = 0
    converged_columns: int | None = None  # batched solves only

    @property
    def converged(self) -> bool:
        if self.converged_columns is not None:
            return self.converged_columns == self.columns
        return self.converged_layers == self.n_layers

    def summary(self) -> str:
        tail = (self.max_dT_history[self.n_iterations - 1]
                if self.n_iterations > 0 else float("nan"))
        conv = (f"conv={self.converged_columns}/{self.columns} cols"
                if self.converged_columns is not None
                else f"conv={self.converged_layers}/{self.n_layers}")
        return (f"iters={self.n_iterations} {conv} "
                f"max|dT|={tail:.2f} K wall={self.wall_seconds:.3f}s")

    @classmethod
    def from_result(cls, result, wall_seconds: float,
                    columns: int = 1) -> "SolveMetrics":
        conv = _np(result.converged)
        hist = _np(result.max_dT_history)
        if hist.ndim == 2:   # batched result: worst column per iteration
            hist = hist.max(axis=0)
        batched = conv.ndim > 1
        return cls(
            n_iterations=int(np.max(_np(result.n_iterations))),
            converged_layers=int(conv.sum()) if not batched
            else int(conv.all(axis=0).sum()),
            n_layers=conv.shape[-1],
            max_dT_history=hist,
            wall_seconds=wall_seconds,
            columns=columns,
            bins=int(result.flux.shape[-1]),
            converged_columns=int(conv.all(axis=-1).sum()) if batched
            else None,
        )


def flux_balance(result, trapz_w) -> np.ndarray:
    """Relative bolometric net-flux spread across the interior layers,
    per column (``frei_tpu.diag.telemetry.flux_balance``): layer 0 is
    left out, since the reference never updates its F_up (`core.py:
    265-266`).  Equilibration telemetry, not a convergence gate: it falls
    with iteration without reaching zero."""
    tw = _np(trapz_w).astype(np.float64)
    net = (_np(result.F_up).astype(np.float64)
           - _np(result.F_down).astype(np.float64)) @ tw     # (..., L)
    net = net[..., 1:]
    emergent = _np(result.flux).astype(np.float64) @ tw
    spread = net.max(axis=-1) - net.min(axis=-1)
    return spread / np.abs(emergent)


def progress_printer(it, max_dT, n_conv, n_layers):
    """The reference's tqdm description line (`core.py:312-315`), one per
    outer iteration."""
    print(f"RC iter {int(it):4d}: max|dT| = {float(max_dT):8.2f} K; "
          f"conv = {int(n_conv)}/{int(n_layers)}", flush=True)


@contextlib.contextmanager
def profile_trace(log_dir):
    """Profile a block with ``torch.profiler`` (the card's kernels too,
    where CUDA is present) and write its Chrome trace into ``log_dir``
    (open it in Perfetto or ``chrome://tracing``).  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


def span(name: str):
    """A context naming a piece of host work ``name`` in a
    ``torch.profiler`` trace (:func:`profile_trace`'s Chrome trace among
    them): a ``record_function`` range while a profiler records, on the
    same clock as the card's kernels; spans nest, the enclosing one the
    parent.  With no profiler active it is a shared null context, and
    enters nothing of torch."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def enable_nan_debugging(enable: bool = True):
    """Check every sweep's outputs for NaN and inf in the solver and the
    standalone drivers (raising ``FloatingPointError``), and turn on
    autograd's anomaly detection, which names the backward operation
    that produced a NaN.  Off by default; when off, nothing is checked
    and no host synchronisation is added."""
    global _NAN_CHECKS
    _NAN_CHECKS = bool(enable)
    torch.autograd.set_detect_anomaly(bool(enable), check_nan=True)


def check_finite(what, *tensors):
    """Raise ``FloatingPointError`` naming ``what`` when NaN debugging is
    on and a tensor holds a NaN or an inf; a no-op when it is off."""
    if _NAN_CHECKS and not all(bool(torch.isfinite(t).all())
                               for t in tensors):
        raise FloatingPointError(f"non-finite values in the {what}")
