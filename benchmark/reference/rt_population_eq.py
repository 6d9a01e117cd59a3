"""The plain reference of a population on equilibrium chemistry: one
planet per column, each with its own irradiation (T*, a/R*), gravity
and alpha, every species' mass mixing ratio read from the reference's
own equilibrium table (``rt_equilibrium``).

``case.build`` works out each planet's F_toa row, g and alpha from the
drawn parameters alone; ``rt_equilibrium.solve`` runs the fixed-horizon
iterations with the per-column physics, ``check_block`` columns at a
time.  In ``dtype`` (float64 for the reference, float32 for the
control).  Plain PyTorch: nothing of the program.
"""

from __future__ import annotations

import torch

from . import case, rt_equilibrium


def forward(cfg, tables, T0, pop, n_iters, dtype, device, block):
    """Flux (C, W), final temperatures (C, L), the layer table ``ln_mmr``
    (L, nT, S) and each planet's F_toa (C, W), g and alpha (C,) of the
    fixed-horizon solve of the (C, L) profiles ``T0`` (float64 numpy) for
    the population ``pop`` (``inputs.Population``), as float64 host
    tensors."""
    s, ph = case.build(rt_equilibrium._as_mock(cfg), tables, dtype, device,
                       pop)
    c = rt_equilibrium.chem(cfg, list(tables), dtype, device)
    flux, temps = [], []
    with torch.no_grad():
        for i in range(0, T0.shape[0], block):
            sl = slice(i, min(i + block, T0.shape[0]))
            sb, pb = case.columns(s, ph, sl)
            r = rt_equilibrium.solve(
                sb, c, pb, torch.as_tensor(T0[sl], dtype=dtype,
                                           device=device), n_iters)
            flux.append(r.flux.double().cpu())
            temps.append(r.final_temps.double().cpu())
        ln = rt_equilibrium.layer_table(c, s.pressures).double().cpu()
    return {"flux": torch.cat(flux), "final_temps": torch.cat(temps),
            "ln_mmr": ln, "F_toa": s.F_toa.double().cpu(),
            "g": ph.g.reshape(-1).double().cpu(),
            "alpha": ph.alpha.reshape(-1).double().cpu()}
