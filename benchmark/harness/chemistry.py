"""The program side of an equilibrium configuration's set-up: the
port's equilibrium chemistry for a configuration's ``chemistry`` block,
built once per process and kept for every later run of the same
configuration on the same device (a run builds it once anyway; the CPU
tests run a cell many times in one process)."""

from __future__ import annotations

import json

#: the port's documented defaults (``FastChemTorch``, ``Grid``'s
#: ``chemistry="equilibrium"``), as a configuration's block names them
DEFAULTS = {"grid_shape": [64, 32], "T_range_K": [500.0, 6000.0],
            "P_range_bar": [1e-8, 1e3]}

_BUILT = {}


def load(ctx, grid):
    """Load the configuration's tables onto ``grid`` (built as
    ``program.make_grid`` builds it) with the chemistry its block
    names: ``chemistry="equilibrium"`` at the defaults, else a
    ``FastChemTorch`` of the block's nodes, in the grid's precision;
    the model built once per (configuration, device, dtype).  Returns
    the model."""
    block = {k: v for k, v in ctx.cfg["chemistry"].items() if k != "kind"}
    key = (ctx.cfg["name"], json.dumps(block, sort_keys=True),
           tuple(ctx.tables), str(ctx.device), ctx.cfg["dtype"])
    chem = _BUILT.get(key)
    if chem is None and _same(block, DEFAULTS):
        grid.load_opacities(opacities=ctx.tables, chemistry="equilibrium")
        chem = grid.chemistry
    elif chem is None:
        from frei_tpu_torch.chemistry.fastchem import FastChemTorch
        chem = FastChemTorch(
            list(ctx.tables), grid.planet.m_bar, mode="table",
            grid_shape=tuple(block["grid_shape"]),
            T_range=tuple(block["T_range_K"]),
            P_range_bar=tuple(block["P_range_bar"]),
            build_device=ctx.device, dtype=ctx.dtype)
    if grid.chemistry is not chem:
        grid.load_opacities(opacities=ctx.tables, chemistry=chem)
    _BUILT[key] = chem
    return chem


def _same(block, defaults) -> bool:
    return set(block) == set(defaults) and all(
        [float(x) for x in block[k]] == [float(x) for x in defaults[k]]
        for k in defaults)
