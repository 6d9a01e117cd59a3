"""The plain reference solve with frei's own convergence: each column
iterates until every one of its layers has converged, then stops and
keeps its state while the others go on (`frei/core.py:233-338`).

frei's rule (`core.py:306-311`): the temperature history holds a row
after every emit and every absorb sweep; a layer has converged once the
signs of the differences of consecutive history rows have changed more
than ``n_zero_crossings`` times, or once the absorb's last change of its
temperature is below ``convergence_dT``; a column stops once all of its
layers have converged, or after ``n_max`` iterations.  The reference
counts the sign changes anew from the whole history after each
iteration, as frei does, where the program counts them as it goes.
A stopped column's temperatures and flux slabs are kept; the final emit
runs on every column's kept state.

The sweeps are ``rt.emit`` and ``rt.absorb`` on the columns still
running; the absorb's change is read as T1 - T2.  In ``dtype`` (float64
for the reference, float32 for the control).  Plain PyTorch: nothing of
the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import case, rt


class Converged(NamedTuple):
    flux: torch.Tensor          # (B, W) emergent spectrum
    final_temps: torch.Tensor   # (B, L) after the final emit
    n_iterations: torch.Tensor  # (B,) iterations each column ran


def flips(history):
    """Sign changes of the differences of consecutive rows of the
    temperature history (B, n, L), per layer (B, L): frei's zero
    crossings."""
    if history.shape[1] < 3:
        return torch.zeros(history.shape[0], history.shape[2],
                           dtype=torch.int64, device=history.device)
    s = torch.sign(torch.diff(history, dim=1))
    return (torch.diff(s, dim=1) != 0).sum(1)


def solve(s: rt.Setup, ph: rt.Physics, T0, n_max: int,
          n_zero_crossings: int, convergence_dT: float) -> Converged:
    """Iterate every column of the (B, L) profiles ``T0`` from zero flux
    until it has converged or run ``n_max`` iterations, then one final
    emit."""
    B, L = T0.shape
    W = s.lam_cm.shape[0]
    F_up = T0.new_zeros((B, L, W))
    F_down = T0.new_zeros((B, L, W))
    T = T0.clone()
    history = T0.new_zeros((B, 2 * n_max, L))
    n_iters = torch.zeros(B, dtype=torch.int64, device=T0.device)
    running = torch.ones(B, dtype=torch.bool, device=T0.device)
    for it in range(n_max):
        idx = running.nonzero().reshape(-1)
        if idx.numel() == 0:
            break
        sb, pb = case.columns(s, ph, idx)
        Fu, Fd, T1 = rt.emit(sb, pb, T[idx], F_up[idx], F_down[idx])
        Fu, Fd, T2 = rt.absorb(sb, pb, T1, Fu, Fd)
        history[idx, 2 * it] = T1
        history[idx, 2 * it + 1] = T2
        T[idx], F_up[idx], F_down[idx] = T2, Fu, Fd
        n_iters[idx] = it + 1
        conv = ((flips(history[idx, :2 * it + 2]) > n_zero_crossings)
                | ((T1 - T2).abs() < convergence_dT))
        running[idx] = ~conv.all(1)
    F_up, _, T = rt.emit(s, ph, T, F_up, F_down)
    return Converged(flux=F_up[:, -1], final_temps=T, n_iterations=n_iters)


def forward(cfg, tables, T0, n_max, n_zero_crossings, convergence_dT, dtype,
            device, block):
    """Flux (C, W), final temperatures (C, L) and each column's
    iteration count (C,) of the converging solve of the (C, L) profiles
    ``T0`` (float64 numpy), as host tensors (float64; int64 counts);
    ``block`` columns at a time."""
    s, ph = case.build(cfg, tables, dtype, device)
    flux, temps, iters = [], [], []
    with torch.no_grad():
        for i in range(0, T0.shape[0], block):
            r = solve(s, ph, torch.as_tensor(T0[i:i + block], dtype=dtype,
                                             device=device),
                      n_max, n_zero_crossings, convergence_dT)
            flux.append(r.flux.double().cpu())
            temps.append(r.final_temps.double().cpu())
            iters.append(r.n_iterations.cpu())
    return {"flux": torch.cat(flux), "final_temps": torch.cat(temps),
            "n_iterations": torch.cat(iters)}


def gaps(got, ref) -> dict:
    """``iters_gap``: the share of columns whose iteration count differs
    from the reference's.  ``flux_gap`` and ``temps_gap``: as
    ``answers.forward_gaps``, over the columns whose counts agree
    (infinite where none does)."""
    n = got["n_iterations"].cpu().long()
    same = n == ref["n_iterations"].cpu().long()
    out = {"iters_gap": float((~same).double().mean())}
    if not bool(same.any()):
        return {**out, "flux_gap": float("inf"), "temps_gap": float("inf")}
    flux, tr = ref["flux"].double().cpu(), ref["final_temps"].double().cpu()
    t = got["final_temps"].double().cpu()[same]
    f = got["flux"].double().cpu()[same]
    rel = (f - flux[same]).abs().amax(-1) / flux[same].abs().amax(-1)
    d = (t - tr[same]).abs() / tr[same]
    return {**out,
            "flux_gap": float(torch.nan_to_num(rel, nan=float("inf")).max()),
            "temps_gap": float(torch.nan_to_num(d, nan=float("inf")).max())}
