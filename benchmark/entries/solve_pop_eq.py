"""solve_pop_eq: ``solve_pop``'s population solve, one planet per
column, on a grid whose opacities are loaded with equilibrium chemistry
(``solve_fwd_eq``'s set-up),

    frei_tpu_torch.parallel.solve_population(T0, grid, planets,
        SolverConfig(n_timesteps, n_zero_crossings=10**6,
                     convergence_dT=0.0, engine=<traffic's engine>))

with a fresh population of ``Planet`` objects each call, drawn from the
seed into a pool during set-up and cycled.  A kept call also keeps each
planet's F_toa, g and alpha as the call handed them to
``solve_rc_batched`` and the (L, nTc, S) ln-MMR layer table of the
chemistry.  Checked: the flux and final temperatures against
``reference/rt_population_eq``'s fixed-horizon solve of the same
profiles and planets, the per-planet rows against the reference's
worked out again from the drawn parameters, and the layer table against
the reference's own equilibrium table (``chem_gap``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.harness import chemistry, pieces, program
from benchmark.reference import inputs, rt_population_eq

_POP = pieces.entry("solve_pop")
_EQ = pieces.entry("solve_fwd_eq")


class State(NamedTuple):
    """``solve_pop``'s state, the chemistry and the layers' pressures."""

    grid: object
    T0: list
    T0_ref: list
    planets: list
    draws: list
    cfg: object
    chem: object
    pressures: torch.Tensor


def prepare(ctx) -> State:
    """The grid with its chemistry (``ctx.chem_build_s``: the model's
    own build wall), refused where the chemistry would hand a solve in
    the configuration's precision a layer table in another; the pool of
    profiles and of populations."""
    from frei_tpu_torch import Planet
    grid = program.make_grid(ctx)
    chem = chemistry.load(ctx, grid)
    p = grid._consts.pressures
    _, tab = chem.layer_ln_mmr_tables(p)
    if tab.dtype != ctx.dtype:
        raise RuntimeError(
            f"the chemistry hands a {ctx.cfg['dtype']} solve {tab.dtype} "
            f"layer tables: a {ctx.cfg['dtype']} equilibrium deployment "
            f"needs {ctx.cfg['dtype']} chemistry")
    ctx.chem_build_s = getattr(chem, "build_seconds", None)
    T0, T0_ref = program.profile_pool(ctx)
    pl = ctx.cfg["planet"]
    rng = ctx.rng(1)
    draws = [inputs.population(rng, ctx.columns, pl["draws"])
             for _ in range(int(ctx.traffic["pool"]))]
    planets = [[Planet(a_rstar=a, m_bar=pl["m_bar"], g=g, T_star=t,
                       alpha=al)
                for a, g, t, al in zip(*(x.tolist() for x in d))]
               for d in draws]
    return State(grid, T0, T0_ref, planets, draws,
                 program.fixed_horizon(ctx, engine=ctx.traffic["engine"]),
                 chem, p)


def call(ctx, st: State, k: int, keep: bool):
    """``solve_pop``'s call ``k``; a kept call also keeps the layer
    table."""
    rec = _POP.call(ctx, st, k, keep)
    if rec is not None:
        rec["out"]["ln_mmr"] = st.chem.layer_ln_mmr_tables(st.pressures)[1]
    return rec


def reference(ctx, rec, dtype):
    return rt_population_eq.forward(
        ctx.cfg, ctx.tables, rec["T0"], rec["pop"],
        int(ctx.traffic["iterations"]), dtype, ctx.device,
        int(ctx.traffic["check_block"]))


def gaps(ctx, rec, ref) -> dict:
    """``solve_fwd_eq``'s gaps (``answers.forward_gaps`` and
    ``chem_gap``), with the population's ``ftoa_gap``, ``g_gap`` and
    ``alpha_gap``."""
    return _EQ.gaps(ctx, rec, ref)
