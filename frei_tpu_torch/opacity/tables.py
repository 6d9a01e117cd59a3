"""Device-resident opacity tables and the kappa lookup.

PyTorch counterpart of ``frei_tpu.opacity.tables``: all binned tables
on one (species, T, P, wavelength) tensor, the 4-point gather bilinear
lookup, the batched lookup kernel behind :func:`kappa_from_stack`
(``ops/kappa_cuda.py``), and the layer-factored form the solver uses
(the pressure axis interpolated once onto the fixed layer grid, leaving
a per-sweep 1-D temperature interpolation expressed as weight rows).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as const
from ..chemistry.names import iso_to_mass_g

__all__ = ["OpacityStack", "LayerKappaTables", "make_opacity_stack",
           "interp_tp", "set_interp_mode", "kappa_from_stack",
           "make_layer_tables", "layer_interp_weights",
           "kappa_from_layer_tables", "load_example_opacity"]

#: None = the kappa kernel for multi-T stacks on a CUDA device, else the
#: gather; "gather" forces the gather; "cuda" demands the kernel.
_INTERP_MODE: Optional[str] = None

#: the JAX package's TPU formulations, by their counterpart here
_TPU_MODES = {"onehot": "gather", "pallas": "cuda"}


def set_interp_mode(mode: Optional[str]) -> None:
    """Select the engine of :func:`kappa_from_stack`: None (the CUDA
    kernel for a multi-T stack on a CUDA device, the gather otherwise),
    ``"gather"`` (always the plain gather) or ``"cuda"`` (always the
    kernel; a stack on the CPU raises).  The JAX package's ``"onehot"``
    and ``"pallas"`` are TPU formulations and are refused."""
    global _INTERP_MODE
    if mode in _TPU_MODES:
        raise ValueError(
            f"interp mode {mode!r} is a TPU formulation of the JAX "
            f"package; its counterpart here is {_TPU_MODES[mode]!r}")
    if mode not in (None, "gather", "cuda"):
        raise ValueError(f"unknown interp mode {mode!r} (expected None, "
                         "'gather' or 'cuda')")
    _INTERP_MODE = mode


class OpacityStack(NamedTuple):
    """Binned opacities for all species on a shared (T, P) grid:
    ``values[s, i, j, w]`` in cm^2 / g, axes ascending."""

    values: torch.Tensor      # (S, nT, nP, W)
    temps: torch.Tensor       # (nT,) ascending [K]
    press_cgs: torch.Tensor   # (nP,) ascending [barye]
    species: tuple            # (S,) isotopologue names
    masses_g: np.ndarray      # (S,) species masses [g], host-side

    @property
    def n_species(self) -> int:
        return self.values.shape[0]

    def to(self, dtype=None, device=None) -> "OpacityStack":
        """The same stack with its tensors on ``device`` in ``dtype``."""
        return self._replace(
            values=self.values.to(dtype=dtype, device=device),
            temps=self.temps.to(dtype=dtype, device=device),
            press_cgs=self.press_cgs.to(dtype=dtype, device=device))


def _canonicalize_axis(coord, values, axis):
    """Sort one table axis ascending and drop duplicate coordinates
    (keep the first occurrence)."""
    coord = np.asarray(coord, dtype=np.float64)
    uniq, first_idx = np.unique(coord, return_index=True)
    return uniq, np.take(values, first_idx, axis=axis)


def make_opacity_stack(tables: dict, dtype=torch.float32,
                       device="cuda") -> OpacityStack:
    """Build an :class:`OpacityStack` on ``device`` (default the card)
    from per-species arrays ``{isotopologue: (values (nT, nP, W),
    temps_K, press_bar)}``."""
    species = tuple(tables.keys())
    ref_T, ref_P = None, None
    stacked = []
    for name in species:
        values, temps, press_bar = tables[name]
        temps, values = _canonicalize_axis(temps, np.asarray(values), 0)
        press_bar, values = _canonicalize_axis(press_bar, values, 1)
        if ref_T is None:
            ref_T, ref_P = temps, press_bar
        elif not (np.array_equal(ref_T, temps)
                  and np.array_equal(ref_P, press_bar)):
            raise ValueError(
                "all species must share the binned (T, P) grid; "
                f"species {name!r} differs")
        stacked.append(values)
    masses = np.array([iso_to_mass_g(s) for s in species])

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return OpacityStack(values=dev(np.stack(stacked)), temps=dev(ref_T),
                        press_cgs=dev(ref_P * const.BAR_TO_CGS),
                        species=species, masses_g=masses)


def _axis_weights(coord, x):
    """Lower index, interpolation fraction and in-range mask for linear
    interpolation of ``x`` on the ascending axis ``coord``.

    The hull test carries an 8-ULP relative tolerance: solver grids put
    lookup points exactly on a table edge, and a last-bit perturbation
    must not zero-fill that layer's molecular opacity."""
    x = torch.as_tensor(x, dtype=coord.dtype, device=coord.device)
    n = coord.shape[0]
    if n == 1:
        # degenerate axis: constant along it (idx 0, frac 0, in range)
        return (torch.zeros(x.shape, dtype=torch.int64, device=x.device),
                torch.zeros_like(x),
                torch.ones(x.shape, dtype=torch.bool, device=x.device))
    idx = torch.clamp(
        torch.searchsorted(coord, x.contiguous(), right=True) - 1,
        0, n - 2)
    x0 = coord[idx]
    x1 = coord[idx + 1]
    frac = (x - x0) / (x1 - x0)
    eps = 8.0 * torch.finfo(coord.dtype).eps
    lo = coord[0] - eps * torch.abs(coord[0])
    hi = coord[-1] + eps * torch.abs(coord[-1])
    in_range = (x >= lo) & (x <= hi)
    return idx, frac, in_range


def interp_tp(stack: OpacityStack, temperature, pressure_cgs):
    """Bilinear (T, P) interpolation of every species' spectrum, zero
    outside the hull (`frei/opacity.py:241-263`), by a 4-point gather.
    Returns shape (S,) + B + (W,) for lookup points of shape B."""
    values = stack.values
    nT = values.shape[1]
    pressure_cgs = torch.as_tensor(pressure_cgs, dtype=values.dtype,
                                   device=values.device)
    temperature = torch.as_tensor(temperature, dtype=values.dtype,
                                  device=values.device)
    temperature, pressure_cgs = torch.broadcast_tensors(temperature,
                                                        pressure_cgs)
    pj, pf, p_ok = _axis_weights(stack.press_cgs, pressure_cgs)
    # a 1-point P axis has pj + 1 == 1: clamp, weighted by pf == 0
    pj1 = torch.clamp(pj + 1, max=values.shape[2] - 1)
    if nT == 1:
        v = values[:, 0]                                   # (S, nP, W)
        out = ((1.0 - pf)[..., None] * v[:, pj]
               + pf[..., None] * v[:, pj1])
        return torch.where(p_ok[..., None], out, 0.0)

    ti, tf, t_ok = _axis_weights(stack.temps, temperature)
    v00 = values[:, ti, pj]            # (S,) + B + (W,)
    v01 = values[:, ti, pj1]
    v10 = values[:, ti + 1, pj]
    v11 = values[:, ti + 1, pj1]
    tf = tf[..., None]
    pf = pf[..., None]
    out = ((1.0 - tf) * ((1.0 - pf) * v00 + pf * v01)
           + tf * ((1.0 - pf) * v10 + pf * v11))
    ok = (t_ok & p_ok)[..., None]
    return torch.where(ok, out, 0.0)


def kappa_from_stack(stack: OpacityStack, mmr, temperature, pressure_cgs,
                     sigma_scat):
    """Total and scattering opacity [cm^2 / g] (`frei/opacity.py:203-269`):
    the MMR-weighted species sum of :func:`interp_tp` plus the Rayleigh
    term.  Returns ``(k_total, sigma_scat)``.

    A stack with more than one temperature point on a CUDA device runs
    the batched lookup kernel (``ops.kappa_cuda.kappa_kernel``) unless
    :func:`set_interp_mode` selects ``"gather"``; the kernel's plain twin
    is the gather below."""
    on_cuda = stack.values.is_cuda
    if _INTERP_MODE == "cuda" and not on_cuda:
        raise ValueError("interp mode 'cuda' needs the stack on a CUDA "
                         f"device, got {stack.values.device}")
    if on_cuda and (_INTERP_MODE == "cuda" or (
            _INTERP_MODE is None and stack.values.shape[1] > 1)):
        from ..ops.kappa_cuda import kappa_kernel
        return kappa_kernel(stack, mmr, temperature, pressure_cgs,
                            sigma_scat)
    return _kappa_gather(stack, mmr, temperature, pressure_cgs, sigma_scat)


def _kappa_gather(stack: OpacityStack, mmr, temperature, pressure_cgs,
                  sigma_scat):
    """The gather form of :func:`kappa_from_stack`, the kernel's twin."""
    per_species = interp_tp(stack, temperature, pressure_cgs)
    k_mol = torch.sum(mmr[..., None] * per_species, dim=0)
    return k_mol + sigma_scat, sigma_scat


class LayerKappaTables(NamedTuple):
    """Per-layer P-interpolated opacity tables: the solver's lookup
    points are always (T_l, p_l) on the fixed layer grid, so bilinear
    interpolation factors into a P-interpolation done once here and a
    per-sweep 1-D interpolation in temperature."""

    tab: torch.Tensor    # (L, S*nT, W): P-interp'd, zero outside P hull
    temps: torch.Tensor  # (nT,) ascending [K]
    n_species: int


def make_layer_tables(stack: OpacityStack, pressures_cgs) -> LayerKappaTables:
    """Hoist the pressure axis of the bilinear interpolation onto the
    fixed layer grid (see :class:`LayerKappaTables`)."""
    v = stack.values                                  # (S, nT, nP, W)
    S, nT, nP, W = v.shape
    pressures_cgs = torch.as_tensor(pressures_cgs, dtype=v.dtype,
                                    device=v.device)
    pj, pf, p_ok = _axis_weights(stack.press_cgs, pressures_cgs)
    w1 = (pf * p_ok)[None, None, :, None]
    w0 = ((1.0 - pf) * p_ok)[None, None, :, None]
    pj1 = torch.clamp(pj + 1, max=nP - 1)
    tabs = w0 * v[:, :, pj, :] + w1 * v[:, :, pj1, :]  # (S, nT, L, W)
    tab = tabs.permute(2, 0, 1, 3).reshape(
        pressures_cgs.shape[0], S * nT, W)            # k = s*nT + t
    return LayerKappaTables(tab=tab.contiguous(), temps=stack.temps,
                            n_species=S)


def layer_interp_weights(lt: LayerKappaTables, mmr, temperature):
    """Species-weighted 1-D T-interpolation weight rows: the
    (..., L, S*nT) tensor W with ``k_mol[..., l, :] = W[..., l, :] @
    lt.tab[l]``.  ``mmr`` is (S, ..., L).  The sweep kernels take these
    rows and contract them with the layer tables themselves."""
    nT = lt.temps.shape[0]
    dt = lt.tab.dtype
    ti, tf, t_ok = _axis_weights(lt.temps, temperature)
    w_lo = ((1.0 - tf) * t_ok).to(dt)
    w_hi = (tf * t_ok).to(dt)
    oh = (torch.nn.functional.one_hot(ti, nT).to(dt) * w_lo[..., None]
          + torch.nn.functional.one_hot(ti + 1, nT).to(dt)
          * w_hi[..., None])
    m = torch.movedim(torch.as_tensor(mmr), 0, -1).to(dt)  # (..., L, S)
    return (m[..., :, None] * oh[..., None, :]).reshape(
        tuple(temperature.shape) + (lt.n_species * nT,))


def kappa_from_layer_tables(lt: LayerKappaTables, mmr, temperature,
                            sigma_scat):
    """Total opacity on the layer grid: the weight rows contracted
    with the per-layer tables.  ``temperature`` is (..., L), ``mmr``
    (S, ..., L).  Returns ``(k_total, sigma_scat)``."""
    ohs = layer_interp_weights(lt, mmr, temperature)
    k_mol = torch.einsum('...lk,lkw->...lw', ohs, lt.tab)
    return k_mol + sigma_scat, sigma_scat


def load_example_opacity(grid, seed: int = 42, scale_factor: float = 20.0,
                         dtype=torch.float32, device=None) -> OpacityStack:
    """Deterministic synthetic water-like opacity fixture, identical to
    ``frei_tpu.opacity.tables.load_example_opacity`` (reference
    `frei/opacity.py:272-342` without its x5 prefactor; see that
    function for the calibration note).  ``device`` defaults to the
    grid's own ``device`` where it has one, else the card."""
    if device is None:
        device = getattr(grid, "device", "cuda")
    lam_um = np.asarray(grid.lam_micron, dtype=np.float64)
    press_bar = np.asarray(grid.pressures_bar, dtype=np.float64)
    temps = np.asarray(grid.init_temperatures, dtype=np.float64)

    rng = np.random.RandomState(seed)  # legacy MT19937, as np.random.seed
    so = (np.exp(-0.5 * (lam_um - 6.0) ** 2 / 2.0 ** 2)
          + 0.8 * np.exp(-0.5 * (lam_um - 0.3) ** 2 / 0.5 ** 2))
    amps = rng.uniform(low=0.1, high=0.2, size=15)
    wls = rng.uniform(low=0.5, high=1.0, size=15)
    for amp, wl in zip(amps, wls):
        so += amp * np.exp(-0.5 * (lam_um - wl) ** 2 / 0.005 ** 2)
    for amp, wl in zip([0.22, 0.2, 0.18],
                       np.logspace(np.log10(1.4), np.log10(2.7), 3)):
        so += amp * np.exp(-0.5 * (lam_um - wl) ** 2 / 0.13 ** 2)

    profile = scale_factor * 10.0 ** (2.5 * (so - 0.4))
    values = np.broadcast_to(
        profile, (temps.shape[0], press_bar.shape[0], lam_um.shape[0])
    ).copy()
    return make_opacity_stack({"1H2-16O": (values, temps, press_bar)},
                              dtype=dtype, device=device)
