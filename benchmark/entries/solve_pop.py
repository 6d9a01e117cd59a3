"""solve_pop: the population solve, one planet per column,

    frei_tpu_torch.parallel.solve_population(T0, grid, planets,
        SolverConfig(n_timesteps, n_zero_crossings=10**6,
                     convergence_dT=0.0, engine=<traffic's engine>))

with a fresh population of ``Planet`` objects each call, drawn from the
seed into a pool during set-up and cycled.  Checked: the flux and final
temperatures, and each planet's F_toa, g and alpha as the call handed
them to ``solve_rc_batched``, against the reference's worked out again
from the drawn parameters."""

from __future__ import annotations

from typing import NamedTuple

from benchmark.harness import program
from benchmark.reference import answers, inputs


class State(NamedTuple):
    grid: object
    T0: list
    T0_ref: list
    planets: list
    draws: list
    cfg: object


def prepare(ctx) -> State:
    from frei_tpu_torch import Planet
    grid = program.make_grid(ctx)
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
                 program.fixed_horizon(ctx, engine=ctx.traffic["engine"]))


def call(ctx, st: State, k: int, keep: bool):
    """Call ``k``; with ``keep``, its inputs and answers for the check,
    and the per-planet rows the population solve built."""
    import frei_tpu_torch.parallel.solve as psolve
    i = k % len(st.T0)
    seen = {}
    if keep:
        inner = psolve.solve_rc_batched

        def spy(T0, consts, params, *args, **kw):
            seen.update(F_toa=consts.F_toa, g=params.g, alpha=params.alpha)
            return inner(T0, consts, params, *args, **kw)
        psolve.solve_rc_batched = spy
    try:
        res = psolve.solve_population(st.T0[i], st.grid, st.planets[i],
                                      st.cfg)
    finally:
        if keep:
            psolve.solve_rc_batched = inner
    out = ({"flux": res.flux.clone(), "final_temps": res.final_temps,
            **seen} if keep else None)
    ctx.sync()
    return None if out is None else {"T0": st.T0_ref[i],
                                     "pop": st.draws[i], "out": out}


def reference(ctx, rec, dtype):
    return answers.forward(ctx.cfg, ctx.tables, rec["T0"], rec["pop"],
                           int(ctx.traffic["iterations"]), dtype,
                           ctx.device, int(ctx.traffic["check_block"]))


def gaps(ctx, rec, ref) -> dict:
    return answers.forward_gaps(rec["out"], ref)
