"""Population solves: one planet per column.

Counterpart of ``frei_tpu.parallel.solve.solve_population`` without a
mesh: the columns of one batched solve on one device.  Sharding columns
over devices (the JAX package's ``mesh``) is ROADMAP queue 1 item 14.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..rt.physics import PhysicsParams
from ..rt.solver import RTResult, SolverConfig, solve_rc_batched
from ..stellar.irradiation import f_toa_np

__all__ = ["solve_population"]


def solve_population(init_temps, grid, planets,
                     cfg: SolverConfig = SolverConfig(),
                     mesh: Optional[object] = None) -> RTResult:
    """Retrieval or phase-curve population solve: one atmosphere per
    planet, each with its own irradiation (T_star, a/R*), gravity and
    mixing-length alpha, sharing the grid, opacities, chemistry and mean
    molecular weight (the composition is shared, so sharing m_bar, which
    sets the Rayleigh scattering and the MMR scale, is the consistent
    choice).

    Parameters
    ----------
    init_temps : (C, L) initial profiles [K], one per planet.
    grid : ``frei_tpu_torch.api.Grid`` with opacities loaded.
    planets : sequence of C ``Planet`` objects.

    Returns a batched :class:`RTResult`: ``solve_rc_batched`` in
    population mode, per-planet F_toa (C, W), g and alpha (C,) on the
    grid's device.  On the ``"cuda"`` engine each column equals a
    shared-planet solve of its planet bit for bit.
    """
    if mesh is not None:
        raise NotImplementedError(
            "solve_population over a device mesh is ROADMAP queue 1 item 14")
    consts = grid._consts
    dtype, device = consts.lam_cm.dtype, consts.lam_cm.device
    lam_cm = np.asarray(grid.rt_grid.lam_cm)
    f_toa = torch.as_tensor(
        np.stack([f_toa_np(lam_cm, p.T_star, p.a_rstar) for p in planets]),
        dtype=dtype, device=device)                       # (C, W)
    g = torch.as_tensor([p.g for p in planets], dtype=dtype, device=device)
    alpha = torch.as_tensor([p.alpha for p in planets], dtype=dtype,
                            device=device)
    m_bar = planets[0].m_bar
    if any(abs(p.m_bar - m_bar) > 1e-30 for p in planets):
        raise ValueError(
            "solve_population shares composition: all planets must "
            "have the same m_bar (it sets chemistry + Rayleigh); "
            "build separate grids for different compositions")
    init_temps = torch.as_tensor(init_temps, dtype=dtype, device=device)
    params = PhysicsParams(g=g, m_bar=torch.as_tensor(m_bar, dtype=dtype,
                                                      device=device),
                           alpha=alpha, n_dof=5)
    return solve_rc_batched(init_temps, consts._replace(F_toa=f_toa),
                            params, grid._kappa_fn, cfg)
