"""Structured per-solve metrics.

Counterpart of ``frei_tpu.diag.telemetry.SolveMetrics``; the profiler
trace, NaN toggle and flux-balance helpers are ROADMAP queue 1 item 13.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SolveMetrics"]


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

    @property
    def columns_bins_per_second(self) -> float:
        if self.wall_seconds <= 0:
            return float("nan")
        return self.columns * self.bins / self.wall_seconds

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
