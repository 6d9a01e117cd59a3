"""solve_fwd: the batched forward solve, the documented call of
docs/torch-port.md and api.py:363-394,

    frei_tpu_torch.solve_rc_batched(T0, grid._consts,
        planet.physics_params(), grid._kappa_fn, SolverConfig(
            n_timesteps, n_zero_crossings=10**6, convergence_dT=0.0,
            engine=<traffic's engine>))

on the next batch of the pool each call.  Checked: the flux (C, W) and
final temperatures (C, L) of the kept calls against the reference's
fixed-horizon solve of the same profiles."""

from __future__ import annotations

from typing import NamedTuple

from benchmark.harness import program
from benchmark.reference import answers


class State(NamedTuple):
    T0: list
    T0_ref: list
    args: tuple
    cfg: object


def prepare(ctx) -> State:
    grid = program.make_grid(ctx)
    T0, T0_ref = program.profile_pool(ctx)
    return State(T0, T0_ref,
                 (grid._consts, grid.planet.physics_params(),
                  grid._kappa_fn),
                 program.fixed_horizon(ctx, engine=ctx.traffic["engine"]))


def call(ctx, st: State, k: int, keep: bool):
    """Call ``k``; with ``keep``, its inputs and answers for the check."""
    from frei_tpu_torch import solve_rc_batched
    i = k % len(st.T0)
    res = solve_rc_batched(st.T0[i], *st.args, st.cfg)
    out = ({"flux": res.flux.clone(), "final_temps": res.final_temps}
           if keep else None)
    ctx.sync()
    return None if out is None else {"T0": st.T0_ref[i], "out": out}


def reference(ctx, rec, dtype):
    return answers.forward(ctx.cfg, ctx.tables, rec["T0"], None,
                           int(ctx.traffic["iterations"]), dtype,
                           ctx.device, int(ctx.traffic["check_block"]))


def gaps(ctx, rec, ref) -> dict:
    return answers.forward_gaps(rec["out"], ref)
