"""frei_tpu_torch: exoplanet radiative transfer in PyTorch and CUDA.

The PyTorch port of ``frei_tpu``, for one NVIDIA H100: the same
grids, opacity plane (on-disk stores, the streamed rebin, the binned
cache, the batched kappa lookup), mock and equilibrium chemistry, and
two-stream radiative-convective solver (batched, per planet and
differentiable; standalone sweep drivers, checkpoints, diagnostics),
with every Pallas kernel of ``frei_tpu`` written by hand in CUDA
(``csrc/*.cu``).  It imports no JAX;
``frei_tpu`` stays the reference it is tested against.

The entry points (``Grid``, ``make_opacity_stack``,
``binned_opacity_stack``, ``load_example_opacity``) put their tensors on
the card unless the caller names another device; where CUDA is absent,
``Grid(...)`` raises unless given ``device="cpu"``.

Quickstart::

    from frei_tpu_torch import Planet, Grid, load_example_opacity

    planet = Planet.from_hot_jupiter()
    grid = Grid(planet, n_wl_bins=300, n_layers=15, T_ref=2400.0)
    # on the CPU: Grid(..., device="cpu")
    grid.load_opacities(opacities=load_example_opacity(grid))
    spec, temps, temp_hist, dtaus = grid.emission_spectrum(n_timesteps=1)

or, from on-disk opacity stores (``opacity.etl``)::

    grid.load_opacities(path="stores/", engine="cuda")
"""

from .api import (Grid, Planet, Spectrum, effective_temperature,
                  effective_temperature_milne, effective_temperature_planck)
from .grids import (RTGrid, make_rt_grid, pressure_grid, temperature_grid,
                    wavelength_grid)
from .opacity.etl import (binned_opacity_stack, make_synthetic_store,
                          opacity_dir_to_store)
from .opacity.tables import (OpacityStack, kappa_from_stack,
                             load_example_opacity, make_opacity_stack,
                             set_interp_mode)
from .rt.physics import PhysicsParams
from .rt.solver import (RTConstants, RTResult, SolverConfig, solve_rc,
                        solve_rc_batched)
from .rt.standalone import StandaloneResult, absorb, emit
from .rt.sweeps import absorb_sweep, emit_sweep
from .stellar.irradiation import b_star, f_toa

__all__ = [
    "Planet", "Grid", "Spectrum",
    "effective_temperature", "effective_temperature_milne",
    "effective_temperature_planck",
    "wavelength_grid", "pressure_grid", "temperature_grid",
    "RTGrid", "make_rt_grid",
    "OpacityStack", "make_opacity_stack", "load_example_opacity",
    "kappa_from_stack", "set_interp_mode",
    "binned_opacity_stack", "make_synthetic_store", "opacity_dir_to_store",
    "PhysicsParams", "SolverConfig", "RTConstants", "RTResult",
    "solve_rc", "solve_rc_batched", "emit_sweep", "absorb_sweep",
    "emit", "absorb", "StandaloneResult",
    "f_toa", "b_star",
]

__version__ = "0.1.0"
