"""Solver-state checkpoint / resume.

Counterpart of ``frei_tpu.io.checkpoint``, with its npz format: the
same field names and the same ``extra_`` prefix for metadata, so a file
written by either package loads in the other.  A snapshot holds the
full solver state (spectrum, temperatures, flux fields, convergence
statistics) and the pre-final-emit ``loop_*`` state, from which a solve
resumes exactly.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["save_solution", "load_solution", "resume_state"]

_FIELDS = ("flux", "final_temps", "temp_history", "n_history", "dtaus",
           "F_up", "F_down", "n_iterations", "converged",
           "max_dT_history", "loop_temps", "loop_F_up", "loop_F_down")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_solution(path, result, **extra) -> Path:
    """Write an :class:`~frei_tpu_torch.rt.solver.RTResult` (one column or
    batched) and optional metadata arrays to an npz file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {k: _np(getattr(result, k)) for k in _FIELDS}
    for k, v in extra.items():
        payload[f"extra_{k}"] = _np(v)
    np.savez_compressed(path, **payload)
    return path


def load_solution(path) -> dict:
    """A saved solution as a dict of numpy arrays.  Its ``final_temps``
    can seed a new solve through ``Grid(..., init_temperatures=...)``."""
    with np.load(Path(path), allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def resume_state(path, dtype=None, device="cuda"):
    """The pieces that continue a checkpointed solve, as tensors on
    ``device`` (in ``dtype``, else the file's): ``(loop_temps,
    (loop_F_up, loop_F_down))``, the pre-final-emit state, so that
    ``solve_rc_batched(temps, ..., init_fluxes=fluxes)`` continues the
    emit / absorb sequence exactly (the convergence statistics restart;
    they only affect the stopping rule)."""
    d = load_solution(path)

    def t(name):
        return torch.as_tensor(d[name], dtype=dtype, device=device)
    return t("loop_temps"), (t("loop_F_up"), t("loop_F_down"))
