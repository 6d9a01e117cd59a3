"""grad_step: one step of a gradient-based retrieval through the
differentiable solve (api.py ``Grid.spectrum_fn``, bench.py's loss),

    fn = grid.spectrum_fn(n_timesteps, n_zero_crossings=10**6,
                          convergence_dT=0.0)
    loss = (fn(T0, planet.physics_params()) ** 2).sum() / 1e26
    torch.autograd.grad(loss, T0)

on the next batch of the pool each step.  In a traced run the forward
and the backward are timed apart (spans ``forward`` and ``backward``,
a synchronize between them).  Checked: the loss and dloss/dT0 at
columns drawn from the seed, against the reference's autograd."""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from benchmark.harness import program
from benchmark.reference import answers


class State(NamedTuple):
    T0: list
    T0_ref: list
    fn: object
    params: object


def prepare(ctx) -> State:
    grid = program.make_grid(ctx)
    T0, T0_ref = program.profile_pool(ctx)
    fn = grid.spectrum_fn(n_timesteps=int(ctx.traffic["iterations"]),
                          n_zero_crossings=10 ** 6, convergence_dT=0.0)
    return State(T0, T0_ref, fn, grid.planet.physics_params())


def call(ctx, st: State, k: int, keep: bool):
    i = k % len(st.T0)
    T = st.T0[i].detach().requires_grad_(True)
    t0 = time.perf_counter()
    loss = (st.fn(T, st.params) ** 2).sum() / 1e26
    if ctx.record_spans:
        ctx.sync()
        t1 = time.perf_counter()
        ctx.span("forward", t1 - t0)
    (grad,) = torch.autograd.grad(loss, T)
    ctx.sync()
    if ctx.record_spans:
        ctx.span("backward", time.perf_counter() - t1)
    if not keep:
        return None
    return {"T0": st.T0_ref[i],
            "out": {"loss": loss.detach(), "grad": grad}}


def _sample(ctx):
    return answers.draws_for_check(ctx.seed, ctx.columns,
                                   int(ctx.traffic["grad_check_columns"]))


def reference(ctx, rec, dtype):
    tr = ctx.traffic
    return answers.gradient(ctx.cfg, ctx.tables, rec["T0"],
                            int(tr["iterations"]), dtype, ctx.device,
                            int(tr["check_block"]),
                            int(tr["grad_check_block"]), _sample(ctx))


def gaps(ctx, rec, ref) -> dict:
    return answers.gradient_gaps(rec["out"], ref, _sample(ctx))
