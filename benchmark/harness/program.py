"""The program side of set-up, shared by the entries: the port's Grid
built from a configuration with the benchmark's raw opacity tables, and
the pool of initial profiles drawn from the seed."""

from __future__ import annotations

import torch

from ..reference import inputs


def make_grid(ctx):
    """``frei_tpu_torch.Grid`` of the configuration, on the run's device
    and dtype, its opacities loaded from the benchmark's tables."""
    from frei_tpu_torch import Grid, Planet
    g = ctx.cfg["grid"]
    grid = Grid(Planet.from_hot_jupiter(),
                lam_min=g["lam_min_um"], lam_max=g["lam_max_um"],
                n_wl_bins=g["n_wl_bins"], P_toa=g["P_toa_bar"],
                P_boa=g["P_boa_bar"], n_layers=g["n_layers"],
                T_ref=g["T_ref"], P_ref=g["P_ref_bar"], alpha=g["alpha"],
                dtype=ctx.dtype, device=ctx.device)
    grid.load_opacities(opacities=ctx.tables)
    return grid


def profile_pool(ctx):
    """``traffic["pool"]`` batches of (C, L) initial profiles: the
    program's tensors, and the same values in float64 for the
    reference."""
    tr = ctx.traffic
    rng = ctx.rng(0)
    dev, ref = [], []
    for _ in range(int(tr["pool"])):
        T0 = inputs.profiles(ctx.grid, rng, ctx.columns,
                             *tr["profile_scale"])
        t = torch.as_tensor(T0, dtype=ctx.dtype, device=ctx.device)
        dev.append(t.contiguous())
        ref.append(t.double().cpu().numpy())
    return dev, ref


def fixed_horizon(ctx, **kw):
    """The traffic's fixed horizon: both convergence exits off, so that
    every call does the same work."""
    from frei_tpu_torch import SolverConfig
    return SolverConfig(n_timesteps=int(ctx.traffic["iterations"]),
                        n_zero_crossings=10 ** 6, convergence_dT=0.0, **kw)
