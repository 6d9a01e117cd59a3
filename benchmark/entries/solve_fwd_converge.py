"""solve_fwd_converge: ``solve_fwd``'s documented call with frei's
default exits in place of the fixed horizon,

    frei_tpu_torch.solve_rc_batched(T0, grid._consts,
        planet.physics_params(), grid._kappa_fn, SolverConfig(
            n_timesteps=<cap>, n_zero_crossings=2, convergence_dT=3.0,
            engine=<traffic's engine>))

on the next batch of the pool each call, so that each column stops once
its layers have converged and the columns freeze apart.  After each
call's synchronize the mean of the result's ``n_iterations`` is read and
handed on (``ctx.spans["n_iterations"]``).  Checked: each column's
iteration count, and the flux (C, W) and final temperatures (C, L) of
the columns whose counts agree, against ``reference/rt_converge``'s
solve of the same profiles under frei's stopping rule."""

from __future__ import annotations

from typing import NamedTuple

from benchmark.harness import program
from benchmark.reference import rt_converge


class State(NamedTuple):
    T0: list
    T0_ref: list
    args: tuple
    cfg: object


def _exits(ctx):
    tr = ctx.traffic
    return (int(tr["iterations"]), int(tr["n_zero_crossings"]),
            float(tr["convergence_dT"]))


def prepare(ctx) -> State:
    from frei_tpu_torch import SolverConfig
    grid = program.make_grid(ctx)
    T0, T0_ref = program.profile_pool(ctx)
    n, nzc, dT = _exits(ctx)
    return State(T0, T0_ref,
                 (grid._consts, grid.planet.physics_params(),
                  grid._kappa_fn),
                 SolverConfig(n_timesteps=n, n_zero_crossings=nzc,
                              convergence_dT=dT,
                              engine=ctx.traffic["engine"]))


def call(ctx, st: State, k: int, keep: bool):
    """Call ``k``; with ``keep``, its inputs and answers for the check."""
    from frei_tpu_torch import solve_rc_batched
    i = k % len(st.T0)
    res = solve_rc_batched(st.T0[i], *st.args, st.cfg)
    out = ({"flux": res.flux.clone(), "final_temps": res.final_temps,
            "n_iterations": res.n_iterations} if keep else None)
    ctx.sync()
    ctx.span("n_iterations", float(res.n_iterations.cpu().double().mean()))
    return None if out is None else {"T0": st.T0_ref[i], "out": out}


def reference(ctx, rec, dtype):
    return rt_converge.forward(ctx.cfg, ctx.tables, rec["T0"], *_exits(ctx),
                               dtype, ctx.device,
                               int(ctx.traffic["check_block"]))


def gaps(ctx, rec, ref) -> dict:
    return rt_converge.gaps(rec["out"], ref)
