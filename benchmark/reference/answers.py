"""The reference's answers for the inputs of a kept call, and the gaps
between the program's answers and them: the comparison that decides
``correct``.

The reference runs in column blocks, so that it fits beside nothing
else on the device once the program's state is freed.  ``dtype`` is
float64 for the reference; the control runs the same code in a lower
precision and is judged by the same gaps.
"""

from __future__ import annotations

import numpy as np
import torch

from . import case, inputs, rt


def _blocks(n, size):
    for i in range(0, n, size):
        yield slice(i, min(i + size, n))


def forward(cfg, tables, T0, pop, n_iters, dtype, device, block):
    """Flux (C, W) and final temperatures (C, L) of the fixed-horizon
    solve of the (C, L) profiles ``T0`` (float64 numpy), and for a
    population each planet's F_toa (C, W), g and alpha (C,), as float64
    host tensors."""
    s, ph = case.build(cfg, tables, dtype, device, pop)
    flux, temps = [], []
    with torch.no_grad():
        for sl in _blocks(T0.shape[0], block):
            sb, pb = case.columns(s, ph, sl)
            r = rt.solve(sb, pb, torch.as_tensor(T0[sl], dtype=dtype,
                                                 device=device), n_iters)
            flux.append(r.flux.double().cpu())
            temps.append(r.final_temps.double().cpu())
    out = {"flux": torch.cat(flux), "final_temps": torch.cat(temps)}
    if pop is not None:
        out.update(F_toa=s.F_toa.double().cpu(),
                   g=ph.g.reshape(-1).double().cpu(),
                   alpha=ph.alpha.reshape(-1).double().cpu())
    return out


def gradient(cfg, tables, T0, n_iters, dtype, device, block, grad_block,
             sample):
    """The loss sum(flux^2) / 1e26 over all columns of ``T0``, and its
    gradient with respect to the profiles at the columns ``sample``
    (each column's gradient depends on that column alone), the autograd
    ``grad_block`` columns at a time."""
    s, ph = case.build(cfg, tables, dtype, device)
    loss = torch.zeros((), dtype=torch.float64)
    with torch.no_grad():
        for sl in _blocks(T0.shape[0], block):
            T = torch.as_tensor(T0[sl], dtype=dtype, device=device)
            flux = rt.solve(s, ph, T, n_iters).flux
            loss += ((flux.double() ** 2).sum() / 1e26).cpu()
    grads = []
    for part in np.array_split(sample,
                               max(1, -(-len(sample) // grad_block))):
        T = torch.as_tensor(T0[part], dtype=dtype,
                            device=device).requires_grad_(True)
        part_loss = (rt.solve(s, ph, T, n_iters).flux ** 2).sum() / 1e26
        (g,) = torch.autograd.grad(part_loss, T)
        grads.append(g.double().cpu())
        del part_loss, g, T
    return {"loss": loss, "grad": torch.cat(grads)}


def _rel_rows(got, ref):
    """Per row: the largest |got - ref| over the row's largest |ref|."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return (got - ref).abs().amax(-1) / ref.abs().amax(-1)


def _worst(x) -> float:
    """The largest reading, NaN counted as infinite."""
    x = torch.nan_to_num(x.double(), nan=float("inf"))
    return float(x.max())


def forward_gaps(got, ref) -> dict:
    """``flux_gap``: the widest gap of a column's spectrum, over that
    column's brightest bin, the worst column.  ``temps_gap``: the widest
    |T - T_ref| / T_ref over every column and layer, the thin top layers
    included.  For a population also ``ftoa_gap``, ``g_gap`` and
    ``alpha_gap``, the widest relative gaps of each planet's
    irradiation, gravity and alpha."""
    t = got["final_temps"].double().cpu()
    tr = ref["final_temps"].double().cpu()
    out = {"flux_gap": _worst(_rel_rows(got["flux"], ref["flux"])),
           "temps_gap": _worst((t - tr).abs() / tr)}
    if "F_toa" in ref:
        out["ftoa_gap"] = _worst(_rel_rows(got["F_toa"], ref["F_toa"]))
        for k in ("g", "alpha"):
            r = ref[k].double().cpu()
            out[f"{k}_gap"] = _worst(
                (got[k].double().cpu().reshape(-1) - r).abs() / r.abs())
    return out


def gradient_gaps(got, ref, sample) -> dict:
    """``loss_gap``: |loss - loss_ref| / |loss_ref|.  ``grad_gap``: per
    sampled column (``got`` holds every column's gradient, or the
    sampled columns' alone), the widest gap of dloss/dT0 over that
    column's largest |dloss/dT0|; the median column (the worst column swings by
    orders of magnitude from seed to seed in any float32 solve, a float32
    reference's as much as the program's: PERF.md)."""
    lr = ref["loss"].double()
    g = got["grad"].double().cpu()
    cols = _rel_rows(g if len(g) == len(sample) else g[sample], ref["grad"])
    return {"loss_gap": _worst((got["loss"].double().cpu() - lr).abs()
                               / lr.abs()),
            "grad_gap": _worst(torch.nan_to_num(cols, nan=float("inf"))
                               .median().reshape(1))}


def draws_for_check(seed: int, n_columns: int, n_sample: int):
    """The columns whose gradients are checked, drawn from the seed."""
    rng = inputs.rng_for(seed, 3)
    return np.sort(rng.choice(n_columns, size=min(n_sample, n_columns),
                              replace=False))
