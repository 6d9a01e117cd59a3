"""solve_fwd_eq: ``solve_fwd``'s documented call on a grid whose
opacities are loaded with equilibrium chemistry
(``Grid.load_opacities(..., chemistry="equilibrium")``, api.py), on the
next batch of the pool each call.  A kept call also keeps the (L, nTc,
S) ln-MMR layer table the chemistry hands the whole-iteration kernels'
pack (``layer_ln_mmr_tables`` of the grid's pressures).  Checked: the
flux (C, W) and final temperatures (C, L) against
``reference/rt_equilibrium``'s fixed-horizon solve of the same
profiles, and the layer table against the reference's own equilibrium
table at the same nodes (``chem_gap``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.harness import chemistry, program
from benchmark.reference import answers, rt_equilibrium


class State(NamedTuple):
    T0: list
    T0_ref: list
    args: tuple
    cfg: object
    chem: object
    pressures: torch.Tensor


def prepare(ctx) -> State:
    """The grid with its chemistry (``ctx.chem_build_s``: the model's
    own build wall); refused where the chemistry would hand a solve in
    the configuration's precision a layer table in another."""
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
    return State(T0, T0_ref,
                 (grid._consts, grid.planet.physics_params(),
                  grid._kappa_fn),
                 program.fixed_horizon(ctx, engine=ctx.traffic["engine"]),
                 chem, p)


def call(ctx, st: State, k: int, keep: bool):
    """Call ``k``; with ``keep``, its inputs and answers for the check."""
    from frei_tpu_torch import solve_rc_batched
    i = k % len(st.T0)
    res = solve_rc_batched(st.T0[i], *st.args, st.cfg)
    out = None
    if keep:
        out = {"flux": res.flux.clone(), "final_temps": res.final_temps,
               "ln_mmr": st.chem.layer_ln_mmr_tables(st.pressures)[1]}
    ctx.sync()
    return None if out is None else {"T0": st.T0_ref[i], "out": out}


def reference(ctx, rec, dtype):
    return rt_equilibrium.forward(ctx.cfg, ctx.tables, rec["T0"],
                                  int(ctx.traffic["iterations"]), dtype,
                                  ctx.device, int(ctx.traffic["check_block"]))


def gaps(ctx, rec, ref) -> dict:
    """``answers.forward_gaps``, and ``chem_gap``: the largest |ln MMR -
    ln MMR_ref| over the layer table (NaN read as infinite)."""
    got = rec["out"]["ln_mmr"].double().cpu()
    d = torch.nan_to_num((got - ref["ln_mmr"]).abs(), nan=float("inf"))
    return {**answers.forward_gaps(rec["out"], ref),
            "chem_gap": float(d.max())}
