"""A configuration's reference constants, worked out from its file and
the drawn inputs alone (never from the program's state)."""

from __future__ import annotations

import numpy as np
import torch

from . import constants as const
from . import inputs
from .rt import Physics, Setup

#: the hot Jupiter of frei `core.py:92-106`: a/R* for 0.03 AU around the
#: Sun, m_bar 2.4 m_p, g of Jupiter, T* 5800 K, alpha 1
HOT_JUPITER = dict(a_rstar=0.03 * const.au / const.R_sun, m_bar=2.4,
                   g_cgs=const.g_jup, T_star=5800.0, alpha=1.0)


def m_bar_g(cfg: dict) -> float:
    planet = cfg["planet"]
    m = HOT_JUPITER["m_bar"] if planet["kind"] == "hot_jupiter" \
        else planet["m_bar"]
    return m * const.m_p


def opacity_tables(cfg: dict, ga: inputs.GridArrays) -> dict:
    """``{isotopologue: (values (nT, nP, W), temps_K, press_bar)}``, the
    raw tables both sides are given: ``"example"``, frei's one-species
    fixture on the grid's own T(P) and pressures; ``"seeded_tp"``,
    several species on seeded T- and P-dependent tables over the
    configuration's log-spaced ``temps_K`` and ``press_bar`` axes."""
    op = cfg["opacity"]
    if op["kind"] == "example":
        return {op["species"]: inputs.example_opacity(ga, op["seed"],
                                                      op["scale_factor"])}
    if op["kind"] == "seeded_tp":
        return inputs.seeded_tp_opacity(
            ga, op["species"], op["seed"], inputs.log_axis(op["temps_K"]),
            inputs.log_axis(op["press_bar"]))
    raise ValueError(f"unknown opacity kind {op['kind']!r}")


def build(cfg: dict, tables: dict, dtype, device, pop=None):
    """``(Setup, Physics)`` in ``dtype`` on ``device``; ``pop`` an
    ``inputs.Population`` for a population configuration."""
    ga = inputs.grid_arrays(cfg["grid"])
    m_bar = m_bar_g(cfg)
    if cfg["chemistry"]["kind"] != "mock":
        raise ValueError(f"unknown chemistry {cfg['chemistry']['kind']!r}")
    vmr = cfg["chemistry"]["vmr"]
    names = list(tables)
    values = np.stack([tables[n][0] for n in names])
    T_axis, P_axis = tables[names[0]][1], tables[names[0]][2]
    order_T, order_P = np.argsort(T_axis), np.argsort(P_axis)
    values = values[:, order_T][:, :, order_P]
    mmr = np.array([vmr * inputs.iso_mass_amu(n) * const.u_amu / m_bar
                    for n in names])
    if pop is None:
        hj = HOT_JUPITER
        F_toa = inputs.f_toa(ga.lam_cm, hj["T_star"], hj["a_rstar"])
        g, alpha = np.float64(hj["g_cgs"]), np.float64(hj["alpha"])
    else:
        F_toa = inputs.f_toa(ga.lam_cm, pop.T_star[:, None],
                             pop.a_rstar[:, None])
        g, alpha = pop.g_si[:, None] * 100.0, pop.alpha[:, None]

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    s = Setup(lam_cm=t(ga.lam_cm), trapz_w=t(ga.trapz_w),
              pressures=t(ga.pressures),
              sigma=t(inputs.rayleigh(ga.lam_cm, m_bar)), F_toa=t(F_toa),
              table=t(values), table_T=t(T_axis[order_T]),
              table_P=t(P_axis[order_P] * const.BAR_TO_CGS), mmr=t(mmr))
    return s, Physics(g=t(g), m_bar=t(m_bar), alpha=t(alpha))


def columns(s: Setup, ph: Physics, sl) -> tuple:
    """The per-column parts of a population's constants cut to the
    columns ``sl``; shared constants are returned whole."""
    if ph.g.ndim == 0:
        return s, ph
    return (s._replace(F_toa=s.F_toa[sl]),
            ph._replace(g=ph.g[sl], alpha=ph.alpha[sl]))
