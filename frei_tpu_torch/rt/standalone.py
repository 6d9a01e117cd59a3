"""Standalone ``emit`` / ``absorb`` drivers with the reference's
public-call conventions.

Counterpart of ``frei_tpu.rt.standalone``.  The reference exposes
``emit`` and ``absorb`` as user-facing functions that (a) self-seed the
flux state when called without one, ``F_down[-1] = F_TOA`` in both plus
``F_up[0] = pi B(T[0])`` in ``absorb``
(`frei/twostream.py:336-339,465-475`), and (b) run their own
multi-timestep loop that stops when ``max|dT| < convergence_thresh``
(default 10 K, `twostream.py:291-293,414-416`).  The Grid driver
instead calls the sweeps one timestep at a time with caller-maintained
state (``rt.solver``).  Here the loop runs the batched eager sweeps of
:mod:`frei_tpu_torch.rt.sweeps` at one column, on the column's device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..diag import telemetry
from ..ops.planck import bb_flux
from .physics import PhysicsParams
from .solver import RTConstants
from .sweeps import absorb_sweep, emit_sweep

__all__ = ["StandaloneResult", "emit", "absorb"]


class StandaloneResult(NamedTuple):
    """Mirror of the reference return tuple (`twostream.py:417-421`)."""

    F_up: torch.Tensor          # (L, W)
    F_down: torch.Tensor        # (L, W)
    final_temps: torch.Tensor   # (L,)
    temp_history: torch.Tensor  # (n_timesteps + 1, L); row 0 = input
    n_history: torch.Tensor     # valid history rows (timesteps run + 1)
    dtaus: torch.Tensor         # (L, W) from the final sweep
    dT: torch.Tensor            # (L,) last temperature change


def _run(direction, init_temps, consts: RTConstants, params: PhysicsParams,
         kappa_all: Callable, n_timesteps, convergence_thresh, fluxes_up,
         fluxes_down, associative) -> StandaloneResult:
    init_temps = torch.as_tensor(init_temps)
    dtype, device = init_temps.dtype, init_temps.device
    L = init_temps.shape[0]
    W = consts.lam_cm.shape[0]
    # the physics scalars in the column's dtype, as the solver pins them
    params = PhysicsParams(
        *(torch.as_tensor(x, dtype=dtype, device=device)
          for x in (params.g, params.m_bar, params.alpha)),
        n_dof=params.n_dof)
    sweep = emit_sweep if direction == "emit" else absorb_sweep
    sweep_kw = dict(sigma_scat=consts.sigma_scat, F_toa=consts.F_toa,
                    lam_cm=consts.lam_cm, trapz_w=consts.trapz_w,
                    pressures=consts.pressures, params=params,
                    associative=associative)
    if fluxes_up is None:
        Fu = torch.zeros((L, W), dtype=dtype, device=device)
        if direction == "absorb":
            # absorb's self-seed: F_up[0] = pi B(T[0]) (`twostream.py:470`)
            Fu[0] = bb_flux(init_temps[0], consts.lam_cm)
    else:
        Fu = torch.as_tensor(fluxes_up, dtype=dtype, device=device)
    if fluxes_down is None:
        # both directions seed F_down[-1] = F_TOA (`twostream.py:339,474`)
        Fd = torch.zeros((L, W), dtype=dtype, device=device)
        Fd[-1] = consts.F_toa
    else:
        Fd = torch.as_tensor(fluxes_down, dtype=dtype, device=device)

    temps = init_temps
    hist = [init_temps]
    dT = torch.zeros((L,), dtype=dtype, device=device)
    dtaus = torch.zeros((L, W), dtype=dtype, device=device)
    for j in range(int(n_timesteps)):
        r = sweep(temps[None], Fu[None], Fd[None],
                  kappa_all(temps[None], consts.pressures), **sweep_kw)
        Fu, Fd, temps, dT, dtaus = (x[0] for x in r)
        telemetry.check_finite(f"{direction} sweep of timestep {j}", Fu,
                               Fd, temps)
        hist.append(temps)
        if float(torch.abs(dT).max()) < convergence_thresh:
            break
    n = len(hist)
    hist += [torch.zeros_like(init_temps)] * (int(n_timesteps) + 1 - n)
    return StandaloneResult(
        F_up=Fu, F_down=Fd, final_temps=temps,
        temp_history=torch.stack(hist),
        n_history=torch.tensor(n, dtype=torch.int32, device=device),
        dtaus=dtaus, dT=dT)


def emit(init_temps, consts: RTConstants, params: PhysicsParams,
         kappa_all: Callable, n_timesteps: int = 50,
         convergence_thresh: float = 10.0, fluxes_up=None,
         fluxes_down=None, associative: bool = False) -> StandaloneResult:
    """Standalone multi-timestep emission driver (reference ``emit``,
    `twostream.py:290-421`) of one (L,) column: bottom-to-top sweeps
    until ``max|dT| < convergence_thresh`` (default 10 K) or
    ``n_timesteps`` (default 50).  An omitted flux state is self-seeded
    with zeros and ``F_down[-1] = F_TOA`` (`twostream.py:336-339`)."""
    return _run("emit", init_temps, consts, params, kappa_all, n_timesteps,
                convergence_thresh, fluxes_up, fluxes_down, associative)


def absorb(init_temps, consts: RTConstants, params: PhysicsParams,
           kappa_all: Callable, n_timesteps: int = 50,
           convergence_thresh: float = 10.0, fluxes_up=None,
           fluxes_down=None, associative: bool = False) -> StandaloneResult:
    """Standalone multi-timestep absorption driver (reference
    ``absorb``, `twostream.py:424-550`) of one (L,) column: top-to-bottom
    sweeps from the self-seeded state ``F_up[0] = pi B(T[0])``,
    ``F_down[-1] = F_TOA`` (`twostream.py:465-475`)."""
    return _run("absorb", init_temps, consts, params, kappa_all,
                n_timesteps, convergence_thresh, fluxes_up, fluxes_down,
                associative)
