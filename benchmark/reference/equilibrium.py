"""The plain reference's equilibrium chemistry: gas-phase abundances by
the law of mass action, solved at any (T, P) nodes (a table's, in
``rt_equilibrium``).

The thermochemical data is a frozen copy of the program's
(``data/chem_tables.npz``: JANAF log K fits and Asplund 2009 solar
abundances, 28 elements with the electron last and 495 gas species).
The law is the one frei reaches through FastChem (Stock et al. 2018;
`frei/chemistry.py:114-205`), with p0 = 1 bar:

* ``ln p_i = ln K_i(T) + sum_j nu_ij lam_j`` for every gas species i,
  ``lam_j = ln p_j`` of each element's atom (and of the electron), and
  ``ln K = a1 / T + a2 ln T + a3 + a4 T + a5 T^2``;
* element conservation ``p_j + sum_i nu_ij p_i = eps_j M`` for every
  element, charge balance ``p_e + sum_anions p_i = sum_cations p_i``
  (every charge is +-1 in the data) and the total pressure
  ``sum p = P``, with ``m = ln M`` the last unknown.

Method, its own: full Newton in the E + 1 unknowns (lam, m) on the
equations in logarithmic form (each side a log-sum-exp, so nothing
overflows where ln K ~ 800), with a backtracking line search on the
squared residual and steps capped at ``MAX_STEP`` in log units.  A
solve starts from the atoms at ``T_HOT``, where molecules are few, and
walks down to the nodes' temperatures in steps of at most ``MAX_DEX``
in log10 T, each warm-started from the last (ln K moves by ~30 over a
table row's 0.017 dex at 500 K, too far for Newton's first step), a
step that fails halved.  Every node is solved until each relative
residual (the difference of the two sides' logarithms) is at most
``TOL``; a node that does not get there raises.

Host numpy, float64.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

DATA = Path(__file__).parent / "data" / "chem_tables.npz"
#: the largest relative residual a solved node may keep
TOL = 1e-12
#: the largest change of any unknown in one Newton step [log units]
MAX_STEP = 4.0
#: Newton steps a node may take before its solve is refused
MAX_STEPS = 50
#: where a solve from the atoms starts [K]: hot enough that the atoms
#: are close to the answer
T_HOT = 6000.0
#: the longest step in log10 T a walk tries
MAX_DEX = 0.02


class Thermo(NamedTuple):
    elements: tuple        # (E,) symbols, "e-" last
    eps: np.ndarray        # (E,) abundances relative to H; the electron 0
    species: tuple         # (S,) gas species
    nu: np.ndarray         # (S, E) signed element counts
    coeffs: np.ndarray     # (S, 5) ln K fit


def load(path=DATA) -> Thermo:
    d = np.load(path, allow_pickle=False)
    return Thermo(tuple(str(e) for e in d["elements"]),
                  np.asarray(d["abundances"], np.float64),
                  tuple(str(s) for s in d["species"]),
                  np.asarray(d["stoich"], np.float64),
                  np.asarray(d["logk_coeffs"], np.float64))


def ln_k(th: Thermo, T):
    """ln K (B, S) at temperatures T (B,)."""
    T = np.asarray(T, np.float64)[:, None]
    a = th.coeffs.T
    return a[0] / T + a[1] * np.log(T) + a[2] + a[3] * T + a[4] * T * T


def _lse(x, axis=-1):
    """log sum exp over ``axis`` and the softmax weights; -inf terms
    (absent) carry no weight."""
    mx = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - mx)
    s = e.sum(axis=axis, keepdims=True)
    return (mx + np.log(s)).squeeze(axis), e / s


class _System:
    """The log-form equations of one thermochemical data set.  Terms:
    every atom and gas species, ``ln p = ln K + A @ lam`` (an atom's ln K
    is 0 and its row of A the identity's); each equation a log-sum-exp
    of some terms minus a right-hand side: element j's carriers, each
    term plus ln(its count of j), minus ln eps_j + m; the electron and
    anions minus the cations (charge); every term minus ln P."""

    def __init__(self, th: Thermo):
        E = len(th.elements)
        self.E, self.ie = E, th.elements.index("e-")
        self.A = np.concatenate([np.eye(E), th.nu])            # (E+S, E)
        self.carriers = [np.nonzero(self.A[:, j] > 0)[0] for j in range(E)]
        self.ln_count = [np.log(self.A[c, j])
                         for j, c in enumerate(self.carriers)]
        q = self.A[:, self.ie]
        self.neg = np.nonzero(q > 0)[0]      # the electron and anions
        self.pos = np.nonzero(q < 0)[0]      # cations
        self.ln_eps = np.log(np.where(th.eps > 0, th.eps, 1.0))

    def residual(self, lnk, ln_P, x):
        """The (B, E + 1) log residuals, their Jacobian (B, E + 1, E + 1)
        and every term's ln p (B, E + S) at the state ``x`` (B, E + 1) =
        (lam, m)."""
        B, E = x.shape[0], self.E
        lam, m = x[:, :E], x[:, E]
        y = np.concatenate([np.zeros((B, E)), lnk], axis=1) + lam @ self.A.T
        F = np.empty((B, E + 1))
        J = np.zeros((B, E + 1, E + 1))
        for j in range(E):
            if j == self.ie:
                a, wa = _lse(y[:, self.neg])
                b, wb = _lse(y[:, self.pos])
                F[:, j] = a - b
                J[:, j, :E] = wa @ self.A[self.neg] - wb @ self.A[self.pos]
                continue
            c = self.carriers[j]
            t, w = _lse(y[:, c] + self.ln_count[j])
            F[:, j] = t - self.ln_eps[j] - m
            J[:, j, :E] = w @ self.A[c]
            J[:, j, E] = -1.0
        t, w = _lse(y)
        F[:, E] = t - ln_P
        J[:, E, :E] = w @ self.A
        return F, J, y


def _start(th: Thermo, lnk, ln_P):
    """Atoms at their abundances, hydrogen split between H and H2 by
    the H2 equilibrium, a trace of electrons."""
    E = len(th.elements)
    ie, iH = th.elements.index("e-"), th.elements.index("H")
    eps = th.eps
    m = ln_P - np.log(eps.sum())
    lam = np.log(np.where(eps > 0, eps, 1.0))[None, :] + m[:, None]
    lam[:, ie] = ln_P - 40.0
    if "H2" in th.species:
        K2 = np.exp(np.minimum(lnk[:, th.species.index("H2")], 600.0))
        pH = (np.sqrt(1.0 + 8.0 * K2 * np.exp(m)) - 1.0) / (4.0 * K2)
        lam[:, iH] = np.log(np.maximum(pH, 1e-300))
    return np.concatenate([lam, m[:, None]], axis=1)


class NotSolved(RuntimeError):
    """A Newton solve that did not reach ``TOL`` within ``MAX_STEPS``."""


def newton(sy: _System, lnk, ln_P, x):
    """Newton steps from ``x`` (B, E + 1) until every node's largest
    relative residual is at most ``TOL``: ``(ln p (B, E + S) of the
    atoms then the gas species, x)``.  A node's step is cut to
    ``MAX_STEP`` and then halved until its squared residual falls."""
    F, J, y = sy.residual(lnk, ln_P, x)
    for _ in range(MAX_STEPS):
        todo = np.abs(F).max(axis=1) > TOL
        if not todo.any():
            return y, x
        dx = np.zeros_like(x)
        try:
            dx[todo] = np.linalg.solve(J[todo], -F[todo][..., None])[..., 0]
        except np.linalg.LinAlgError as e:
            raise NotSolved(f"a singular Jacobian ({e})") from e
        big = np.abs(dx).max(axis=1, keepdims=True)
        dx *= np.minimum(1.0, MAX_STEP / np.maximum(big, MAX_STEP))
        f0 = (F ** 2).sum(axis=1)
        step = np.ones((x.shape[0], 1))
        for _ in range(30):
            xt = x + step * dx
            Ft, Jt, yt = sy.residual(lnk, ln_P, xt)
            bad = todo & ~((Ft ** 2).sum(axis=1) < f0)
            if not bad.any():
                break
            step[bad] *= 0.5
        else:
            raise NotSolved("no step along Newton's direction lowers the "
                            "residual")
        x, F, J, y = xt, Ft, Jt, yt
    raise NotSolved(f"a relative residual of {np.abs(F).max():.3e} is "
                    f"left after {MAX_STEPS} Newton steps (> {TOL:g})")


def walk(th: Thermo, T_from, T_to, P_bar, x=None, sy=None):
    """Nodes at pressures ``P_bar`` (B,) walked from the temperatures
    ``T_from`` (B,), solved in ``x`` (or, without it, from the atoms),
    to ``T_to`` (B,) along log T: each step a Newton solve from the last
    step's state, a step that fails halved.  Returns ``(ln_p, x)`` at
    ``T_to``."""
    sy = _System(th) if sy is None else sy
    T_from = np.asarray(T_from, np.float64)
    T_to = np.asarray(T_to, np.float64)
    ln_P = np.log(np.asarray(P_bar, np.float64))
    if x is None:
        lnk = ln_k(th, T_from)
        x = newton(sy, lnk, ln_P, _start(th, lnk, ln_P))[1]
    span = float(np.abs(np.log10(T_to / T_from)).max())
    h_max = 1.0 if span <= MAX_DEX else MAX_DEX / span
    done, h = 0.0, h_max
    y = None
    while y is None or done < 1.0:
        h = min(h, h_max, 1.0 - done)
        T = T_from * (T_to / T_from) ** (done + h)
        try:
            y, x_new = newton(sy, ln_k(th, T), ln_P, x)
        except NotSolved:
            if h < 1e-6:
                raise
            h *= 0.5
            continue
        x, done, h = x_new, done + h, 2.0 * h
    return y, x


def solve(th: Thermo, T, P_bar):
    """Any (B,) nodes: each solved from the atoms at ``T_HOT`` and its
    own pressure, then walked down to its temperature.  Returns ``ln_p``
    (B, E + S), the atoms' then the gas species'."""
    T = np.asarray(T, np.float64)
    P_bar = np.broadcast_to(np.asarray(P_bar, np.float64), T.shape)
    return walk(th, np.full(T.shape, T_HOT), T, P_bar)[0]
